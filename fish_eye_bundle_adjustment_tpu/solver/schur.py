"""Schur-complement Gauss-Newton solver — the scalable path.

The reference materializes a dense n x u design matrix and inverts the
dense normal matrix every iteration (main.m:424-443, O(u^3)).  This solver
never materializes A or N.  Per-observation Jacobian blocks feed a
block-sparse normal system:

    [ Hcc  Hcp ] [dc]   [gc]         c = poses (6/img) + shared IOPs
    [ Hpc  Hpp ] [dp] = [gp]         p = tie points (3/pt)

Point blocks are eliminated in closed form (Hpp is block-diagonal 3x3,
batched inverse), and the reduced camera system

    S dc = gc - Hcp Hpp^-1 gp,   S = Hcc - Hcp Hpp^-1 Hpc

is solved matrix-free with preconditioned conjugate gradients: every
S-matvec is two passes of gather -> per-observation 2xk block products ->
segment-sum, with no scatter of pair blocks.  The preconditioner is exact Schur-Jacobi on the pose diagonal
(each (image, point) pair has exactly one observation, so the diagonal
Schur correction is itself a segment sum).

Free-network datum (Inner_Constraints): CG runs projected onto
null(G^T) — the CG solution of the projected system coincides with the
bordered KKT solution of the dense path (tested against it on cam0).

Distribution: all per-observation work is embarrassingly parallel and all
coupling flows through the segment sums, so the same kernel runs sharded
over an ``obs`` mesh axis by injecting ``reduce_fn = psum`` after every
segment sum (see parallel/dist_schur.py).  Per-observation data travels as
an explicit ObsData pytree so shard_map can shard it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fish_eye_bundle_adjustment_tpu.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu.ops.segment import DualAxisPlan
from fish_eye_bundle_adjustment_tpu.models.projection import (
    MODEL_IDS,
    obs_jacobian_blocks,
    residual_obs,
)
from fish_eye_bundle_adjustment_tpu.solver.constraints import (
    build_G,
    validate_inner_constraints,
)
from fish_eye_bundle_adjustment_tpu.solver.dense import DenseResult
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout
from fish_eye_bundle_adjustment_tpu.utils import checkpoint as ckpt_mod
from fish_eye_bundle_adjustment_tpu.utils.observe import (
    IterationRecord,
    SolverDivergence,
    Stopwatch,
    check_divergence,
)


def _segsum(vals, idx, num, sorted_idx: bool = False):
    return jnp.zeros((num,) + vals.shape[1:], vals.dtype).at[idx].add(
        vals, indices_are_sorted=sorted_idx
    )


def _expand_sym(sym, k):
    """(m, k(k+1)/2) symmetric columns -> (m, k, k)."""
    pairs = [(e, f) for e in range(k) for f in range(e, k)]
    out = jnp.zeros(sym.shape[:1] + (k, k), sym.dtype)
    for idx, (e, f) in enumerate(pairs):
        out = out.at[:, e, f].set(sym[:, idx])
        if e != f:
            out = out.at[:, f, e].set(sym[:, idx])
    return out


def _clamp_diag(d):
    """Marquardt-diagonal relative floor per block row: each entry of a
    (b, k) diag-block table clamped to >= 1e-6 * the row's max entry (and
    an absolute 1e-30), so lam * diag damping regularizes EVERY direction
    of the block — a ~0 diagonal entry otherwise leaves its direction
    unregularized at any lam (see linearize's Hpp note)."""
    mx = jnp.max(d, axis=-1, keepdims=True)
    return jnp.maximum(d, jnp.maximum(1e-6 * mx, 1e-30))


def _stable_sum(vals):
    """Two-stage chunked summation: pads to a multiple of 1024 and reduces
    (n/1024, 1024) -> (n/1024,) -> scalar.  Guarantees tree-shaped
    accumulation independent of XLA's reduce lowering, keeping the f32
    relative error of a 1M-term weighted SSR near sqrt(N)*eps instead of
    N*eps — the LM gain ratio subtracts two such sums, so accumulation
    noise directly widens the accept slack."""
    flat = vals.reshape(-1)
    pad = (-flat.shape[0]) % 1024
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
    return jnp.sum(jnp.sum(flat.reshape(-1, 1024), axis=1))


def _inv3x3(M):
    """Batched closed-form (adjugate) 3x3 inverse: pure elementwise
    arithmetic instead of jnp.linalg.inv's batched LU."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    rows = [
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([D, E, F], axis=-1),
        jnp.stack([G, H, I], axis=-1),
    ]
    return jnp.stack(rows, axis=-2) * inv_det[..., None, None]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ObsData:
    """Per-observation arrays — the shardable axis of the problem."""

    img: jax.Array  # (n,) int32 image index
    cam: jax.Array  # (n,) int32 camera index
    pt: jax.Array  # (n,) int32 target index (into the full point table)
    tie: jax.Array  # (n,) int32 tie slot, == n_tie for control obs
    xy: jax.Array  # (n, 2) measured coordinates
    W: jax.Array  # (n, 2) weights (0 on padding rows)
    # per-CAMERA tables (replicated under sharding; constants are never
    # expanded to the obs axis)
    ydir_cam: jax.Array  # (n_cam,)
    iop_scale_cam: jax.Array  # (n_cam, 3+nk+2) distortion conditioning
    # scatter-free reduction plan (tie-sorted primary axis + image-sorted
    # secondary permutation); None -> scatter fallback (distributed shards)
    plan: Optional[DualAxisPlan] = None

    @staticmethod
    def from_problem(problem: BAProblem, layout: ParamLayout, dtype=np.float64,
                     pad_to: Optional[int] = None,
                     order: Optional[np.ndarray] = None,
                     with_plan: bool = False,
                     shard_plans: Optional[int] = None) -> "ObsData":
        """`order` optionally permutes the observation axis (e.g. sorted by
        tie slot so point-segment sums see sorted indices — see
        sort_order_by_tie).  `shard_plans=n` builds per-shard reduction
        plans (stacked on a leading axis) for shard_map over n devices."""
        n = problem.n_obs
        tie = problem.target_tie_slot[problem.obs_pt]
        tie = np.where(tie >= 0, tie, layout.n_tie).astype(np.int32)
        pad = (pad_to or n) - n

        def _prep(a, fill=0):
            if order is not None:
                a = a[order]
            if pad:
                width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, width, constant_values=fill)
            return a

        W = problem.obs_weights().astype(dtype)
        plan = None
        if with_plan:
            if order is None:
                raise ValueError("with_plan requires a tie-sorted order")
            tie_p = _prep(tie, fill=layout.n_tie)
            img_p = _prep(problem.obs_img)
            if shard_plans:
                plan = DualAxisPlan.build_sharded(
                    tie_p, layout.n_tie + 1, img_p, layout.n_img, shard_plans
                )
            else:
                plan = DualAxisPlan.build(
                    tie_p, layout.n_tie + 1, img_p, layout.n_img
                )
        return ObsData(
            plan=plan,
            img=jnp.asarray(_prep(problem.obs_img)),
            cam=jnp.asarray(_prep(problem.obs_cam)),
            pt=jnp.asarray(_prep(problem.obs_pt)),
            tie=jnp.asarray(_prep(tie, fill=layout.n_tie)),
            xy=jnp.asarray(_prep(problem.obs_xy.astype(dtype))),
            W=jnp.asarray(_prep(W)),  # zero weight rows: padding contributes nothing
            ydir_cam=jnp.asarray(problem.y_dir.astype(dtype)),
            iop_scale_cam=jnp.asarray(layout.iop_scale_full.astype(dtype)),
        )

    def pspec(self, obs_axis: str):
        """shard_map/device_put spec tree: per-observation leaves sharded on
        `obs_axis`, per-camera tables replicated.  Sharded-plan leaves
        (stacked per-shard, leading axis = shard slot) shard on axis 0."""
        from jax.sharding import PartitionSpec as P

        sh, rep = P(obs_axis), P()
        return ObsData(
            img=sh, cam=sh, pt=sh, tie=sh, xy=sh, W=sh,
            ydir_cam=rep, iop_scale_cam=rep,
            plan=None if self.plan is None else jax.tree.map(
                lambda a: sh if a.ndim == 2 else rep,  # stacked per-shard
                self.plan,
            ),
        )

    @staticmethod
    def sort_order_by_tie(problem: BAProblem, layout: ParamLayout) -> np.ndarray:
        """Stable observation order sorted by tie slot (control obs last)."""
        tie = problem.target_tie_slot[problem.obs_pt]
        tie = np.where(tie >= 0, tie, layout.n_tie)
        return np.argsort(tie, kind="stable")

    @property
    def n(self):
        return self.img.shape[0]


@dataclasses.dataclass
class SchurOptions:
    cg_tol: float = 1e-10  # relative residual tolerance for the inner CG
    cg_maxiter: int = 500
    point_damping: float = 0.0  # optional LM damping on Hpp
    camera_damping: float = 0.0  # optional LM damping on the reduced system
    dtype: np.dtype = np.float64
    obs_order: Optional[str] = "tie"  # None | "img" | "tie" observation sort
    # Explicitly materialize the dense reduced camera system S once per GN
    # step (solver/explicit.py) so CG matvecs become dense GEMVs instead of
    # per-observation stream passes.  None -> auto: on when n_img <=
    # explicit_s_max_images (dense S memory is 36*nc^2 floats) and the
    # observation order is "tie" (the pair plan needs the sorted stream).
    # The pair-stream build (one gather per observation pair plus a
    # (P, 36) segment sum) grows with the pair count, so the auto gate
    # stays at small problems where the exact dense preconditioner
    # shortens CG instead; pass explicit_s=True to force it (e.g. ahead
    # of dense-S covariance).  The 600-image gate was tuned on an earlier
    # accelerator and is yet to be measured on the GPU.
    explicit_s: Optional[bool] = None
    explicit_s_max_images: int = 600
    # Inexact-Newton forcing (Eisenstat-Walker style): the inner CG runs to
    # max(cg_tol, min(forcing_max, rel_progress^2)) — loose solves early in
    # the outer Gauss-Newton iteration, tight solves at the end, preserving
    # the converged solution while cutting most CG sweeps.
    adaptive_forcing: bool = True
    forcing_max: float = 1e-2
    # Globalization (r5): adaptive Levenberg-Marquardt trust-region
    # schedule.  Undamped Gauss-Newton genuinely diverges on
    # strongly-nonlinear large blocks (5k-image synth blocks reach NaN in
    # 4-6 iterations of f32 Gauss-Newton; a 24-image
    # 3-camera self-cal block diverges at iteration 18).  The step
    # evaluates the TRUE weighted SSR at the trial point (one extra
    # residual-only pass) and run_gn_loop accepts/rejects on the gain
    # ratio rho = actual / predicted decrease (the predicted decrease is
    # the linearized v'Pv the step already computes for sigma0^2),
    # updating lambda with Nielsen's schedule.  Damping is
    # Marquardt-scaled (lambda * diag H): Hpp diagonals scale by
    # (1 + lambda) inside the elimination — so the damped Hpp^-1 flows
    # consistently through the reduced rhs, back-substitution, and
    # preconditioner — and the reduced camera system gets
    # lambda * diag(S) via the Schur-Jacobi diagonal the preconditioner
    # already materializes.  lambda enters the jitted step as a TRACED
    # scalar (no recompilation across accept/reject), starts at 0, and
    # stays 0 while every step is accepted: well-behaved problems follow
    # the exact pure-GN trajectory (x*(1+0) and +0*v are arithmetic
    # no-ops).  The LM fixed point equals the GN fixed point — damping
    # sits in the step operator, never in the gradient (main.m:412's
    # iterate-to-convergence contract is preserved, now robustly).
    adaptive_damping: bool = True
    init_damping: float = 0.0  # lambda_0 (0 -> pure GN until a rejection)
    damping_kick: float = 1e-4  # lambda floor applied at the first rejection
    max_damping: float = 1e10  # exceeded -> SolverDivergence
    # Plateau (precision-floor) detection: an f32 solve at scale reaches a
    # delta L1 noise floor above any reference-style threshold (measured:
    # the 5k-image block plateaus at 588 = 3.9e-4/unknown with sigma0^2 =
    # 1.0005 by iteration ~6, then oscillates within 0.1% forever).  When
    # the last 5 accepted deltas are flat within 2% AND not improving vs
    # the previous 5 (and damping has decayed), the iteration is at its
    # precision floor: stop, report converged with stopped_on="plateau".
    # Never triggers on a healthy f64 trajectory (deltas fall by orders of
    # magnitude per iteration).
    plateau_detection: bool = True
    # Device-resident GN driver (solver/device_loop.py): run device_chunk
    # outer iterations per host round trip inside one lax.while_loop —
    # the full deferred-LM accept/reject, forcing, and stopping logic
    # executes on device, so a solve pays one host sync per chunk instead
    # of one per GN step.
    # None -> auto: on for the standard matrix-free path (pairs is None)
    # when no trajectory history was requested; progress callbacks still
    # fire per iteration (replayed per chunk) and checkpoints land on
    # chunk boundaries.  False -> always the host loop.
    device_loop: Optional[bool] = None
    device_chunk: int = 16


class SchurKernel:
    """Static problem structure + the block-sparse linear algebra.

    `reduce_fn` is applied after every observation-axis segment sum —
    identity on one device, ``lax.psum(_, 'obs')`` under shard_map.
    """

    def __init__(self, layout: ParamLayout, opts: SchurOptions,
                 reduce_fn: Callable = lambda x: x,
                 obs_order: Optional[str] = None):
        self.layout = layout
        self.opts = opts
        self.reduce = reduce_fn
        # which observation-axis segment reductions see sorted indices
        self.sorted_img = obs_order == "img"
        self.sorted_tie = obs_order == "tie"
        self.model_id = MODEL_IDS[layout.problem.settings.model]
        self.nk = layout.nk
        self.n_img = layout.n_img
        self.n_cam = layout.n_cam
        self.n_tie = layout.n_tie
        self.ne = layout.n_eop
        self.ni = layout.n_iop
        self.nc = layout.eop_size + layout.iop_size

    # -- linearization ---------------------------------------------------
    def blocks(self, q, obs: ObsData):
        """Residual + Jacobian blocks for (a shard of) the observations.

        Returned split by residual row (x/y) as 2-D arrays — every array
        that feeds a reduction stays (N, k) with k flat rather than
        (N, 2, k)."""
        layout = self.layout
        eop, iop, pts = layout.unpack_scaled(q)
        eop_o = eop[obs.img]
        xyz_o = pts[obs.pt]

        fn = lambda e, i, x, oxy, yd: obs_jacobian_blocks(
            e, i, x, oxy, yd, self.model_id, self.nk
        )
        if self.n_cam == 1:
            # single camera (the common case): IOPs and y_dir are constants
            # — close over them instead of gathering 1M-row tables
            r, Je, Ji, Jp = jax.vmap(fn, in_axes=(0, None, 0, 0, None))(
                eop_o, iop[0], xyz_o, obs.xy, obs.ydir_cam[0]
            )
        else:
            r, Je, Ji, Jp = jax.vmap(fn)(
                eop_o, iop[obs.cam], xyz_o, obs.xy, obs.ydir_cam[obs.cam]
            )
        if self.ne:
            cols = jnp.asarray(layout.eop_cols)
            Jex, Jey = Je[:, 0, cols], Je[:, 1, cols]
        else:
            Jex = Jey = Je[:, 0, :0]
        if self.ni:
            if self.n_cam == 1:
                Jis = Ji / obs.iop_scale_cam[0][None, None, :]
            else:
                Jis = Ji / obs.iop_scale_cam[obs.cam][:, None, :]
            cols = jnp.asarray(layout.iop_cols)
            Jix, Jiy = Jis[:, 0, cols], Jis[:, 1, cols]
        else:
            Jix = Jiy = Ji[:, 0, :0]
        live = (obs.tie < self.n_tie)[:, None]
        Jpx = Jp[:, 0, :] * live
        Jpy = Jp[:, 1, :] * live
        return r[:, 0], r[:, 1], Jex, Jey, Jix, Jiy, Jpx, Jpy

    def residual_cost(self, q, obs: ObsData):
        """True weighted SSR at q over (a shard of) the observations —
        residual rows only, no Jacobians: the LM merit function.  Padded
        rows (W == 0) are masked BEFORE the product so garbage residuals
        on padding can't poison the sum with 0 * inf."""
        layout = self.layout
        eop, iop, pts = layout.unpack_scaled(q)
        fn = lambda e, i, x, oxy, yd: residual_obs(
            e, i, x, oxy, yd, self.model_id, self.nk
        )
        if self.n_cam == 1:
            r = jax.vmap(fn, in_axes=(0, None, 0, 0, None))(
                eop[obs.img], iop[0], pts[obs.pt], obs.xy, obs.ydir_cam[0]
            )
        else:
            r = jax.vmap(fn)(
                eop[obs.img], iop[obs.cam], pts[obs.pt], obs.xy,
                obs.ydir_cam[obs.cam],
            )
        w = obs.W
        rm = jnp.where(w > 0, r, 0.0)
        return self.reduce(
            _stable_sum(w[:, 0] * rm[:, 0] ** 2 + w[:, 1] * rm[:, 1] ** 2)
        )

    def linearize(self, q, obs: ObsData, lam=None) -> "SchurFactors":
        """`lam` (traced scalar or None) is the adaptive LM parameter:
        Marquardt scaling multiplies the Hpp diagonal by (1 + lam), so the
        damped Hpp^-1 flows through elimination, reduced rhs,
        back-substitution, and preconditioner consistently.  None (the
        covariance/posegraph callers) keeps the undamped operator."""
        rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy = self.blocks(q, obs)
        nt = self.n_tie
        wx, wy = obs.W[:, 0], obs.W[:, 1]
        # Hpp in symmetric 6-column form [00 01 02 11 12 22]
        cols = []
        for a in range(3):
            for b in range(a, 3):
                cols.append(wx * Jpx[:, a] * Jpx[:, b] + wy * Jpy[:, a] * Jpy[:, b])
        sym6 = jnp.stack(cols, axis=1)  # (N, 6)
        if obs.plan is not None:
            Hs = self.reduce(obs.plan.primary_sum(sym6))[:nt]
        else:
            Hs = self.reduce(
                _segsum(sym6, obs.tie, nt + 1, sorted_idx=self.sorted_tie)
            )[:nt]
        Hpp_inv = self._damped_hpp_inv(Hs, lam) if nt else jnp.zeros(
            (0, 3, 3), rx.dtype
        )
        # row-flattened with a zero dummy row for per-observation gathers
        Hpi_flat = jnp.concatenate(
            [Hpp_inv.reshape(nt, 9), jnp.zeros((1, 9), Hpp_inv.dtype)], axis=0
        )
        # adaptive LM: raw diag(Hcc) as a flat camera vector.  Damping must
        # use the UNDAMPED full-system diagonal (what the dense path damps
        # via N + lam*diag(N)) — NOT diag(S): the Schur correction can
        # drive diag(S) toward zero exactly in the weakly-determined
        # directions that need damping most (measured: the 24-img/3-cam
        # selfcal block limit-cycles under lam*diag(S) damping but
        # converges in a handful of iterations under lam*diag(Hcc),
        # matching the dense LM trajectory).
        dcc = None
        if lam is not None:
            parts = []
            if self.ne:
                de = wx[:, None] * Jex**2 + wy[:, None] * Jey**2  # (N, ne)
                if obs.plan is not None:
                    u = obs.plan.secondary_sum(de)
                else:
                    u = _segsum(de, obs.img, self.n_img,
                                sorted_idx=self.sorted_img)
                parts.append(_clamp_diag(self.reduce(u)).reshape(-1))
            if self.ni:
                di = wx[:, None] * Jix**2 + wy[:, None] * Jiy**2
                if self.n_cam == 1:
                    ui = jnp.sum(di, axis=0, keepdims=True)
                else:
                    ui = _segsum(di, obs.cam, self.n_cam)
                parts.append(_clamp_diag(self.reduce(ui)).reshape(-1))
            dcc = (
                jnp.concatenate(parts) if parts
                else jnp.zeros((0,), rx.dtype)
            )
        return SchurFactors(
            self, obs, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy, Hpi_flat,
            dcc,
        )

    def _damped_hpp_inv(self, Hs, lam):
        """(nt, 6) sym columns -> damped, inverted (nt, 3, 3) blocks.

        Marquardt diag with a PER-TIE relative floor: a tie whose Jpx
        (say) column is ~0 has i00 ~ 0, and pure lam*diag leaves that
        direction unregularized — worse, the f32 cofactor det of the
        damped block then flips sign (det ~ -lam*(i01^2 d2 + i02^2 d1))
        and Hpp^-1 entries GROW ~ lam: at 5k images in f32, the
        reduced rhs then scales ~ lam and every damped trial step
        explodes ~ lam.  Clamping each diag entry to >= 1e-6 * the tie's
        max diag (the Ceres min_diagonal device) keeps the damped block
        PD for every lam."""
        lam_fix = self.opts.point_damping + 1e-300
        i00, i01, i02, i11, i12, i22 = (Hs[:, j] for j in range(6))
        if lam is None:
            d0 = d1 = d2 = 0.0
        else:
            mx = jnp.maximum(jnp.maximum(i00, i11), i22)
            floor = 1e-6 * mx
            d0 = lam * jnp.maximum(i00, floor)
            d1 = lam * jnp.maximum(i11, floor)
            d2 = lam * jnp.maximum(i22, floor)
        Hpp = jnp.stack(
            [
                jnp.stack([i00 + d0 + lam_fix, i01, i02], axis=1),
                jnp.stack([i01, i11 + d1 + lam_fix, i12], axis=1),
                jnp.stack([i02, i12, i22 + d2 + lam_fix], axis=1),
            ],
            axis=1,
        )  # (nt, 3, 3)
        return _inv3x3(Hpp)


@jax.tree_util.register_pytree_node_class
class SchurFactors:
    """One linearization point: residuals + blocks + eliminated points.

    All per-observation arrays are 2-D (N, k); per-observation vectors are
    carried as (x, y) pairs of (N,)/(N, k) arrays."""

    def __init__(self, kernel, obs, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy,
                 Hpi_flat, dcc=None):
        self.k = kernel
        self.obs = obs
        self.rx, self.ry = rx, ry
        self.Jex, self.Jey = Jex, Jey
        self.Jix, self.Jiy = Jix, Jiy
        self.Jpx, self.Jpy = Jpx, Jpy
        self.Hpi_flat = Hpi_flat  # (n_tie + 1, 9), zero dummy row
        # raw diag(Hcc) camera vector for adaptive-LM damping (None when
        # the linearization was built undamped)
        self.dcc = dcc

    def tree_flatten(self):
        return (
            self.obs, self.rx, self.ry, self.Jex, self.Jey, self.Jix,
            self.Jiy, self.Jpx, self.Jpy, self.Hpi_flat, self.dcc,
        ), self.k

    @classmethod
    def tree_unflatten(cls, kernel, leaves):
        return cls(kernel, *leaves)

    # -- building blocks -------------------------------------------------
    @property
    def _w(self):
        return self.obs.W[:, 0], self.obs.W[:, 1]

    def _split(self, vc):
        k = self.k
        vp_img = vc[: k.layout.eop_size].reshape(k.n_img, k.ne)
        vi_cam = vc[k.layout.eop_size :].reshape(k.n_cam, k.ni)
        return vp_img, vi_cam

    def _cam_apply(self, vc):
        """(ax, ay) = C vc per observation, C = [Je | Ji]."""
        k = self.k
        vp_img, vi_cam = self._split(vc)
        ax = jnp.zeros_like(self.rx)
        ay = jnp.zeros_like(self.ry)
        if k.ne:
            vg = vp_img[self.obs.img]  # (N, ne) row gather
            ax = ax + jnp.sum(self.Jex * vg, axis=1)
            ay = ay + jnp.sum(self.Jey * vg, axis=1)
        if k.ni:
            if k.n_cam == 1:
                vi = vi_cam[0]
                ax = ax + self.Jix @ vi
                ay = ay + self.Jiy @ vi
            else:
                vg = vi_cam[self.obs.cam]
                ax = ax + jnp.sum(self.Jix * vg, axis=1)
                ay = ay + jnp.sum(self.Jiy * vg, axis=1)
        return ax, ay

    def _cam_applyT(self, bx, by):
        """C^T b fully reduced into the replicated camera vector."""
        k = self.k
        parts = []
        if k.ne:
            g = self.Jex * bx[:, None] + self.Jey * by[:, None]  # (N, ne)
            if self.obs.plan is not None:
                u = self.obs.plan.secondary_sum(g)
            else:
                u = _segsum(g, self.obs.img, k.n_img, sorted_idx=k.sorted_img)
            parts.append(u.reshape(-1))
        if k.ni:
            g = self.Jix * bx[:, None] + self.Jiy * by[:, None]
            if k.n_cam == 1:
                u = jnp.sum(g, axis=0, keepdims=True)
            else:
                u = _segsum(g, self.obs.cam, k.n_cam)
            parts.append(u.reshape(-1))
        out = jnp.concatenate(parts) if parts else jnp.zeros((0,), self.rx.dtype)
        return k.reduce(out)

    def _point_applyT(self, bx, by):
        """P^T b -> (n_tie, 3), fully reduced (dummy slot dropped)."""
        k = self.k
        tp = self.Jpx * bx[:, None] + self.Jpy * by[:, None]  # (N, 3)
        if self.obs.plan is not None:
            t = self.obs.plan.primary_sum(tp)
        else:
            t = _segsum(tp, self.obs.tie, k.n_tie + 1, sorted_idx=k.sorted_tie)
        return k.reduce(t[: k.n_tie])

    def _point_apply(self, vp):
        """(px, py) = P vp per observation; control obs contribute zero."""
        vp_ext = jnp.concatenate([vp, jnp.zeros((1, 3), vp.dtype)], axis=0)
        yg = vp_ext[self.obs.tie]  # (N, 3) row gather
        return jnp.sum(self.Jpx * yg, axis=1), jnp.sum(self.Jpy * yg, axis=1)

    def _hpp_inv_apply(self, t):
        """y = Hpp^-1 t at tie scale: (n_tie, 3) -> (n_tie, 3)."""
        k = self.k
        H = self.Hpi_flat[: k.n_tie].reshape(k.n_tie, 3, 3)
        return jnp.einsum("tpq,tq->tp", H, t)

    # -- Schur pieces ----------------------------------------------------
    def schur_matvec(self, vc):
        """S vc = C'WC vc - C'WP Hpp^-1 P'WC vc."""
        k = self.k
        wx, wy = self._w
        ax, ay = self._cam_apply(vc)
        awx, awy = wx * ax, wy * ay
        if k.n_tie:
            t = self._point_applyT(awx, awy)
            y = self._hpp_inv_apply(t)
            # fold the correction into one image-axis reduction:
            # C'(aw) - C'(W P y) = C'(aw - W P y)
            px, py = self._point_apply(y)
            awx = awx - wx * px
            awy = awy - wy * py
        out = self._cam_applyT(awx, awy)
        if k.opts.camera_damping:
            out = out + k.opts.camera_damping * vc
        return out

    def reduced_rhs(self):
        """gc_tilde = -(C'W r - C'WP Hpp^-1 P'W r)."""
        k = self.k
        wx, wy = self._w
        rwx, rwy = wx * self.rx, wy * self.ry
        if k.n_tie:
            t = self._point_applyT(rwx, rwy)
            y = self._hpp_inv_apply(t)
            px, py = self._point_apply(y)
            rwx = rwx - wx * px
            rwy = rwy - wy * py
        return -self._cam_applyT(rwx, rwy)

    def back_substitute(self, dc):
        """dp = Hpp^-1 (-P'W r - P'W C dc)  -> (n_tie, 3) in layout tie
        slot order."""
        k = self.k
        if not k.n_tie:
            return jnp.zeros((0, 3), self.rx.dtype)
        wx, wy = self._w
        ax, ay = self._cam_apply(dc)
        rhs = -self._point_applyT(wx * (self.rx + ax), wy * (self.ry + ay))
        return self._hpp_inv_apply(rhs)

    def pose_precond_sym(self):
        """Per-observation symmetric columns (N, ne(ne+1)/2) of the
        pose-diagonal Schur blocks (Hcc diag minus the Hpp^-1 correction),
        UN-reduced — the single-device path reduces with the plan, the
        sharded-state path with psum_scatter.

        Each (image, point) pair is observed once, so the diagonal Schur
        correction Sum_o Je_o' W Jp_o Hpp^-1 Jp_o' W Je_o is one segment
        sum over observations.  Symmetric-column form keeps reduction
        operands 2-D."""
        k = self.k
        ne = k.ne
        wx, wy = self._w
        pairs = [(e, f) for e in range(ne) for f in range(e, ne)]
        cols = [
            wx * self.Jex[:, e] * self.Jex[:, f]
            + wy * self.Jey[:, e] * self.Jey[:, f]
            for e, f in pairs
        ]
        if k.n_tie:
            Hg = self.Hpi_flat[self.obs.tie]  # (N, 9) row gather
            # B[e, p] = (Je' W Jp)[e, p] per observation
            B = [
                [
                    wx * self.Jex[:, e] * self.Jpx[:, p]
                    + wy * self.Jey[:, e] * self.Jpy[:, p]
                    for p in range(3)
                ]
                for e in range(ne)
            ]
            # C[e, q] = sum_p B[e, p] H[p, q]
            C = [
                [
                    sum(B[e][p] * Hg[:, 3 * p + qq] for p in range(3))
                    for qq in range(3)
                ]
                for e in range(ne)
            ]
            for idx, (e, f) in enumerate(pairs):
                corr = sum(C[e][q] * B[f][q] for q in range(3))
                cols[idx] = cols[idx] - corr
        return jnp.stack(cols, axis=1)  # (N, ne(ne+1)/2)

    def iop_precond_sym(self):
        """Per-observation symmetric columns (N, ni(ni+1)/2) of the IOP
        diagonal blocks, un-reduced (see pose_precond_sym)."""
        k = self.k
        ni = k.ni
        wx, wy = self._w
        return jnp.stack(
            [
                wx * self.Jix[:, e] * self.Jix[:, f]
                + wy * self.Jiy[:, e] * self.Jiy[:, f]
                for e in range(ni) for f in range(e, ni)
            ],
            axis=1,
        )

    def pose_precond_blocks(self):
        """Exact Schur-Jacobi diagonal: per-image (ne,ne) blocks of S."""
        k = self.k
        sym = self.pose_precond_sym()
        if self.obs.plan is not None:
            out_sym = self.obs.plan.secondary_sum(sym)
        else:
            out_sym = _segsum(sym, self.obs.img, k.n_img, sorted_idx=k.sorted_img)
        out = _expand_sym(k.reduce(out_sym), k.ne)
        if k.opts.camera_damping:
            out = out + k.opts.camera_damping * jnp.eye(k.ne, dtype=out.dtype)
        return out

    def iop_precond_blocks(self):
        k = self.k
        sym = self.iop_precond_sym()
        if k.n_cam == 1:
            out_sym = jnp.sum(sym, axis=0, keepdims=True)
        else:
            out_sym = _segsum(sym, self.obs.cam, k.n_cam)
        out = _expand_sym(k.reduce(out_sym), k.ni)
        if k.opts.camera_damping:
            out = out + k.opts.camera_damping * jnp.eye(k.ni, dtype=out.dtype)
        return out

    def _precond_apply_from(self, Ms):
        def apply(vc):
            vp_img, vi_cam = self._split(vc)
            parts = []
            for kind, Minv in Ms:
                if kind == "pose":
                    parts.append(jnp.einsum("bij,bj->bi", Minv, vp_img).reshape(-1))
                else:
                    parts.append(jnp.einsum("bij,bj->bi", Minv, vi_cam).reshape(-1))
            return jnp.concatenate(parts)

        return apply

    def _precond_from_blocks(self, blocks, lam):
        """Invert Schur-Jacobi diagonal blocks into the preconditioner
        apply fn, first damping each block's diagonal by lam * the
        matching slice of raw diag(Hcc) (self.dcc) — the same damping the
        LM matvec adds, so the preconditioner approximates the actual
        damped operator S + lam*diag(Hcc).  `blocks` is [(kind, B)] with
        B (b, k, k) in [pose | iop] order matching the dcc layout."""
        eye_reg = 1e-300
        Ms = []
        off = 0
        for kind, B in blocks:
            nb = B.shape[-1]
            nrow = B.shape[0]
            eye = jnp.eye(nb, dtype=B.dtype)
            if lam is not None and self.dcc is not None:
                d = self.dcc[off : off + nrow * nb].reshape(nrow, nb)
                B = B + lam * d[..., None] * eye
            off += nrow * nb
            Ms.append((kind, jnp.linalg.inv(B + eye_reg * eye)))
        return self._precond_apply_from(Ms)

    def make_preconditioner(self, lam=None):
        """(preconditioner, raw diag(Hcc) or None); lam damps the blocks
        (see _precond_from_blocks)."""
        k = self.k
        blocks = []
        if k.ne:
            blocks.append(("pose", self.pose_precond_blocks()))
        if k.ni:
            blocks.append(("iop", self.iop_precond_blocks()))
        return self._precond_from_blocks(blocks, lam), self.dcc


_CG_UNROLL = 8  # iterations fused per while_loop trip (see _pcg)


def _pcg(matvec, b, precond, project, tol, maxiter, dot=None):
    """Projected preconditioned CG with masked-unrolled iterations.

    `project` restricts iterates to null(G^T) for free-network solves
    (identity otherwise).

    The state is an arbitrary pytree (the flat single-device case is the
    trivial one-leaf instance); `dot` supplies the inner product —
    defaulting to the flat jnp.vdot, while the sharded-camera-state solver
    (parallel/sharded_state.py) passes a psum-reducing dot over its
    (pose_shard, iop) tree.

    XLA cannot pipeline or CSE across a while_loop boundary, so
    iterations are unrolled in blocks of _CG_UNROLL with per-iteration
    masking (alpha/beta forced to 0 once ||r|| <= tol||b|| or the
    iteration budget is spent, making converged iterations exact no-ops),
    and the while_loop steps over blocks.  Small static budgets
    (maxiter <= 2*_CG_UNROLL, the adaptive-forcing regime) unroll fully
    with no loop at all.  Semantics match the classic guarded loop: same
    updates while active, stop by tol or maxiter exactly."""
    if dot is None:
        dot = jnp.vdot
    add = lambda a, b_: jax.tree.map(jnp.add, a, b_)
    sub = lambda a, b_: jax.tree.map(jnp.subtract, a, b_)
    scl = lambda c, a: jax.tree.map(lambda l: c * l, a)
    where = lambda m, a, b_: jax.tree.map(
        lambda u, v: jnp.where(m, u, v), a, b_
    )

    b = project(b)
    bnorm2 = dot(b, b)
    tol2 = tol * tol * bnorm2

    def mv(v):
        return project(matvec(project(v)))

    def masked_iter(state):
        i, x, r, z, p, rz, ok = state
        rn2 = dot(r, r)
        active = jnp.logical_and(jnp.logical_and(rn2 > tol2, i < maxiter), ok)
        Ap = mv(p)
        pAp = dot(p, Ap)
        # Curvature guard: on a PD system pAp > 0 in exact arithmetic,
        # but f32/bf16 rounding near the CG noise floor of an
        # ill-conditioned system can measure pAp <= 0 — the unguarded
        # alpha = rz/pAp then takes a huge wrong-signed step and the
        # iterate's quadratic model EXPLODES (measured on a 5k-image f32
        # block: model cost 1e11 from a 1e7 start).  Terminate instead:
        # the current iterate is the best this precision supports.
        ok = jnp.logical_and(ok, pAp > 0)
        take = jnp.logical_and(active, pAp > 0)
        alpha = jnp.where(take, rz / jnp.where(pAp != 0, pAp, 1.0), 0.0)
        x = add(x, scl(alpha, p))
        r = sub(r, scl(alpha, Ap))
        z = project(precond(r))
        rz_new = dot(r, z)
        beta = jnp.where(take, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
        p = where(take, add(z, scl(beta, p)), p)
        rz = jnp.where(take, rz_new, rz)
        return i + take.astype(jnp.int32), x, r, z, p, rz, ok

    x0 = jax.tree.map(jnp.zeros_like, b)
    z0 = project(precond(b))
    state = (jnp.int32(0), x0, b, z0, z0, dot(b, z0), jnp.bool_(True))

    if maxiter <= 2 * _CG_UNROLL:
        for _ in range(maxiter):
            state = masked_iter(state)
    else:
        def cond(state):
            i, x, r, *_, ok = state
            return jnp.logical_and(
                jnp.logical_and(i < maxiter, dot(r, r) > tol2), ok
            )

        def block(state):
            for _ in range(_CG_UNROLL):
                state = masked_iter(state)
            return state

        state = jax.lax.while_loop(cond, block, state)
    i, x, r, *_ = state
    return x, i, jnp.sqrt(dot(r, r) / bnorm2)


def make_projection_builder(layout, nc, use_ic: bool):
    """Null(G^T) projector factory for free-network CG."""

    def build(q):
        if not use_ic:
            return lambda v: v
        G = build_G(layout, q)[:nc]  # G is zero on tie rows
        GtG_inv = jnp.linalg.inv(G.T @ G)

        def project(v):
            return v - G @ (GtG_inv @ (G.T @ v))

        return project

    return build


def step_precision():
    """Matmul-precision context for the contractions of a GN step.

    On the GPU a float32 dot may run in TF32 (about three decimal digits)
    at the default precision.  The step's contractions set the
    Gauss-Newton fixed point (reduced rhs, back-substitution, explicit S)
    and the preconditioner, so they run at HIGHEST (full f32) unless the
    caller set ``jax.default_matmul_precision`` explicitly.  f64
    contractions are exact either way."""
    return jax.default_matmul_precision(
        jax.config.jax_default_matmul_precision or "highest"
    )


def schur_step_fn(kernel: SchurKernel, layout: ParamLayout, use_ic: bool,
                  pairs=None):
    """One (damped) Gauss-Newton step as a pure function of
    (x, obs, cg_tol, lam) — the unit the single-device path jits directly
    and the distributed path wraps in shard_map.  `lam` is the traced
    adaptive-LM parameter (pass 0.0 for a pure GN step).

    With `pairs` (a solver.explicit.PairPlan), the reduced camera system is
    materialized densely once per step and CG runs with GEMV matvecs and a
    preconditioner read off S's diagonal; otherwise the matrix-free stream
    matvec is used.  The returned step takes the plan as a TRACED argument
    (`step(x, obs, cg_tol, lam, pairs)`) — embedding the
    multi-million-element pair index arrays as jit closure constants sends
    XLA's constant machinery into multi-minute compiles.

    Returns (x_trial, L1(delta), v_local, stats, cg_iters) with stats =
    [vPv_model, sum_vx2, sum_vy2, cost_old, cost_new]: vPv_model is the
    LINEARIZED weighted SSR at the trial point (sigma0^2 numerator, and
    the LM predicted cost), cost_old/cost_new the TRUE weighted SSR at the
    current/trial point (the LM merit function; cost_new is one extra
    residual-only pass).  The step traces under step_precision()."""
    opts = kernel.opts
    scale = jnp.asarray(layout.scale, dtype=opts.dtype)
    project_builder = make_projection_builder(layout, kernel.nc, use_ic)
    explicit = pairs is not None
    adaptive = opts.adaptive_damping

    def step(x, obs: ObsData, cg_tol, lam=0.0, pair_arg=None):
        with step_precision():
            return _step(x, obs, cg_tol, lam, pair_arg)

    def _step(x, obs, cg_tol, lam, pair_arg):
        q = x * scale
        lam_t = lam if adaptive else None
        fac = kernel.linearize(q, obs, lam=lam_t)
        wx, wy = obs.W[:, 0], obs.W[:, 1]
        rxm = jnp.where(wx > 0, fac.rx, 0.0)
        rym = jnp.where(wy > 0, fac.ry, 0.0)
        cost_old = kernel.reduce(_stable_sum(wx * rxm**2 + wy * rym**2))
        project = project_builder(q)
        if explicit:
            from fish_eye_bundle_adjustment_tpu.solver.explicit import (
                build_dense_S,
                dense_precond,
            )

            S = build_dense_S(fac, pair_arg)
            if lam_t is not None:
                # damp with raw diag(Hcc) — the dense-parity LM geometry
                S = S + lam_t * fac.dcc * jnp.eye(S.shape[0], dtype=S.dtype)
            matvec = lambda v: S @ v
            precond = dense_precond(S, kernel)
            rhs = fac.reduced_rhs()
        else:
            rhs = fac.reduced_rhs()
            precond, dvec = fac.make_preconditioner(lam_t)
            if lam_t is not None:
                base_mv = fac.schur_matvec
                matvec = lambda v: base_mv(v) + (lam_t * dvec) * v
            else:
                matvec = fac.schur_matvec
        dc, cg_iters, cg_rel = _pcg(
            matvec, rhs, precond, project, cg_tol, opts.cg_maxiter
        )
        dp = fac.back_substitute(dc)
        delta_q = jnp.concatenate([dc, dp.reshape(-1)])
        delta_x = delta_q / scale
        # per-shard linearized residual rows (padding rows carry W=0 but the
        # raw residual of padded obs is bogus — mask by weight sign)
        ax, ay = fac._cam_apply(dc)
        px, py = fac._point_apply(dp)
        vx = jnp.where(wx > 0, ax + px + fac.rx, 0.0)
        vy = jnp.where(wy > 0, ay + py + fac.ry, 0.0)
        # weighted sums for sigma0^2 / RMS (global via reduce)
        vPv = kernel.reduce(_stable_sum(vx * vx * wx + vy * vy * wy))
        sum_vx2 = kernel.reduce(jnp.sum(vx * vx))
        sum_vy2 = kernel.reduce(jnp.sum(vy * vy))
        x_trial = x + delta_x
        # NO trial-point cost here: the LM controller validates a trial
        # DEFERRED, against the NEXT step's cost_old (the linearization at
        # the trial point computes the true residuals anyway) — the extra
        # residual-only pass would cost a full residual sweep for
        # information the next step produces for free.
        stats = jnp.stack([vPv, sum_vx2, sum_vy2, cost_old])
        v_local = jnp.stack([vx, vy], axis=1)
        return x_trial, jnp.sum(jnp.abs(delta_x)), v_local, stats, cg_iters

    return step


def run_gn_loop(step, obs, layout, problem, opts: SchurOptions,
                keep_history=False, x0=None, progress_fn=None,
                checkpoint_path=None, checkpoint_every: int = 1,
                x_sharding=None):
    """The outer Gauss-Newton driver shared by solve_schur and
    solve_schur_distributed: convergence on L1 of the de-scaled correction
    vs Threshold_Value with Iteration_Cap (main.m:412,487-493), adaptive
    Eisenstat-Walker forcing for the inner CG tolerance, divergence
    detection, progress callbacks, and checkpoint/resume.

    `step(x, obs, cg_tol, lam) -> (x_trial, deltasum, v_local, stats,
    cg_iters)` is the jitted single-device or shard_map step (stats =
    [vPv_model, sum_vx2, sum_vy2, cost_old, cost_new]).  Returns
    (x, history, delta_history, v_local, stats, count, converged, elapsed).

    Globalization (opts.adaptive_damping): trust-region-style LM control.
    Each step is a TRIAL: the gain ratio rho = (cost_old - cost_new) /
    (cost_old - vPv_model) — true vs predicted decrease of the weighted
    SSR — drives accept/reject and Nielsen's lambda schedule
    (accept: lam *= max(1/3, 1-(2 rho-1)^3), nu=2; reject: lam = max(
    nu*lam, damping_kick), nu *= 2, x unchanged).  lambda starts at
    init_damping (default 0) and stays 0 while steps keep being accepted,
    so well-behaved problems follow the exact undamped GN trajectory.
    Tiny steps (L1 <= threshold) are always accepted: at the fixed point
    the damped and undamped corrections coincide.  A small relative slack
    absorbs f32 summation noise in the cost difference near convergence.
    lambda > max_damping raises SolverDivergence (no finite damping makes
    progress — e.g. a structurally singular problem).

    `keep_history` copies the full (u,) unknown vector to the host every
    iteration (u=300k x 60 iters ~ 145 MB inside the timed solve) — leave
    it off unless trajectory plots were requested (cli.py passes
    keep_history=plot).
    """
    settings = problem.settings
    t0 = time.perf_counter()
    x = jnp.asarray(
        (layout.initial() if x0 is None else np.asarray(x0)).astype(opts.dtype)
    )
    if x_sharding is not None:
        # commit x to the step's replicated output sharding up front —
        # otherwise the second iteration (fed the step's own output)
        # changes the input sharding and forces a recompilation
        x = jax.device_put(x, x_sharding)
    history = [np.asarray(x)] if keep_history else []
    delta_history = []
    v_local = None
    stats = jnp.zeros(3)
    converged = False
    count = 0
    delta0 = None
    cg_tol = opts.forcing_max if opts.adaptive_forcing else opts.cg_tol
    # resume from a prior checkpoint when one exists (utils/checkpoint.py)
    if checkpoint_path is not None:
        resumed = ckpt_mod.load_checkpoint(checkpoint_path, problem)
        if resumed is not None:
            x = jnp.asarray(resumed.x.astype(opts.dtype))
            count = resumed.iteration
            delta_history = list(resumed.delta_history)
            if delta_history:
                delta0 = max(delta_history[0], 1e-300)
                rel = delta_history[-1] / delta0
                cg_tol = max(opts.cg_tol, min(opts.forcing_max, rel * rel))
    watch = Stopwatch()
    adaptive = opts.adaptive_damping
    stopped_on = "cap"
    lam = float(opts.init_damping)
    nu = 2.0
    # cost-difference slack eps^(2/3) * cost (the scipy-TRF convention):
    # summation noise and genuine sub-noise-floor changes near the fixed
    # point must never REJECT — a rejection there restarts lambda churn on
    # differences with no statistical meaning (and breaks step-for-step
    # parity with the dense path, whose costs round differently)
    slack_rel = float(np.finfo(np.dtype(opts.dtype)).eps) ** (2.0 / 3.0)

    # DEFERRED trust-region control: a trial step's true cost is read off
    # the NEXT step's linearization (its cost_old), so the steady state
    # pays ZERO extra passes; only a rejection (rare: the converged 5k/10k
    # runs have none) pays the wasted step from the bad trial point.
    # `pend` holds the yet-unvalidated trial:
    #   (x_prev, cost_prev, model, deltasum, v, stats, lam_used)
    pend = None

    def accept_pending():
        """Bookkeeping when the pending trial becomes an accepted iterate."""
        nonlocal count, x, v_local, stats, delta0, cg_tol, converged
        nonlocal stopped_on
        count += 1
        deltasum = pend["delta"]
        x, v_local, stats = pend["x_new"], pend["v"], pend["stats"]
        delta_history.append(deltasum)
        if not adaptive:
            check_divergence(count, deltasum, delta_history)
        if progress_fn is not None:
            progress_fn(IterationRecord(
                count, deltasum, watch.lap(), cg_tol, damping=lam,
            ))
        if checkpoint_path is not None and count % checkpoint_every == 0:
            ckpt_mod.save_checkpoint(
                checkpoint_path,
                ckpt_mod.SolverCheckpoint(
                    x=np.asarray(x), iteration=count,
                    delta_history=delta_history,
                    meta={k: str(v) for k, v in
                          ckpt_mod.problem_fingerprint(problem).items()},
                ),
            )
        if opts.adaptive_forcing:
            delta0 = delta0 or max(deltasum, 1e-300)
            rel = deltasum / delta0
            cg_tol = max(opts.cg_tol, min(opts.forcing_max, rel * rel))
        if keep_history:
            history.append(np.asarray(x))
        # Convergence on the reference's L1-of-correction contract
        # (main.m:412) — but under ACTIVE damping a tiny step only means
        # lambda is large, not that the gradient vanished; require the
        # damping decayed back to ~pure GN first.
        if deltasum <= settings.threshold and (not adaptive or lam <= 1e-3):
            converged = True
            stopped_on = "threshold"
            return True
        if (
            opts.plateau_detection
            and len(delta_history) >= 10
            and lam <= 1e-3
        ):
            last = delta_history[-5:]
            prev = delta_history[-10:-5]
            m_last = sum(last) / 5.0
            m_prev = sum(prev) / 5.0
            flat = (max(last) - min(last)) <= 0.02 * abs(m_last)
            improving = m_last < 0.98 * m_prev
            if flat and not improving:
                converged = True
                stopped_on = "plateau"
                return True
        if count >= settings.iteration_cap:
            stopped_on = "cap"
            return True
        return False

    while True:
        x_in = pend["x_new"] if pend is not None else x
        x_trial, deltasum, v_trial, stats_t, _ = step(
            x_in, obs, jnp.asarray(cg_tol, opts.dtype),
            jnp.asarray(lam, opts.dtype),
        )
        deltasum = float(deltasum)
        s = np.asarray(stats_t, dtype=np.float64)
        cost_here = s[3]  # TRUE weighted SSR at x_in
        if pend is not None and adaptive:
            # validate the pending trial against the cost its point shows
            actual = pend["cost_prev"] - cost_here
            pred = pend["cost_prev"] - pend["model"]
            slack = slack_rel * max(pend["cost_prev"], 1.0)
            finite = np.isfinite(cost_here) and np.isfinite(pend["delta"])
            tiny = finite and pend["delta"] <= settings.threshold
            accept = tiny or (finite and actual >= -slack)
            if not accept:
                lam = max(lam * nu, opts.damping_kick)
                nu = min(nu * 2.0, 64.0)
                if lam > opts.max_damping:
                    raise SolverDivergence(
                        count + 1, pend["delta"], delta_history)
                if progress_fn is not None:
                    progress_fn(IterationRecord(
                        count, pend["delta"], watch.lap(), cg_tol,
                        accepted=False, damping=lam,
                    ))
                pend = None  # roll back; current outputs are from the bad
                continue  # trial point and are discarded with it
            rho = actual / pred if pred > slack else 1.0
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            if lam < 1e-14:
                lam = 0.0
            nu = 2.0
        if pend is not None:
            if accept_pending():
                break
        pend = {
            "x_new": x_trial, "cost_prev": cost_here, "model": s[0],
            "delta": deltasum, "v": v_trial, "stats": stats_t,
        }
        # a tiny trial needs no validation (at the fixed point damped and
        # undamped corrections coincide) — and neither does a pure-GN
        # trial when adaptivity is off
        if not adaptive or (
            np.isfinite(deltasum) and deltasum <= settings.threshold
        ):
            if accept_pending():
                break
            pend = None
    elapsed = time.perf_counter() - t0
    return (x, history, delta_history, v_local, stats, count, converged,
            elapsed, stopped_on)


def unpermute_v(v_local, order, n_obs):
    """Undo the solver's observation sort (and drop padding) so residual
    rows line up with the input .pho order."""
    v_sorted = np.asarray(v_local)[:n_obs]
    if order is not None:
        v_unsorted = np.empty_like(v_sorted)
        v_unsorted[order] = v_sorted
        v_sorted = v_unsorted
    return v_sorted.reshape(-1)


def _finalize(problem, layout, x, history, delta_history, v_np, stats, count,
              converged, elapsed, keep_history, stopped_on=None):
    vPv, sx2, sy2 = (float(s) for s in np.asarray(stats)[:3])
    n = problem.n
    dof = n - layout.u
    if dof <= 0:
        # a free-network sub-block (e.g. a posegraph partition with thin
        # overlap, parallel/posegraph.py) can re-estimate nearly every
        # observation's parameters; the reference contract sigma0^2 =
        # v'Pv/(n-u) (main.m:601) would then be inf/negative.  Clamp and
        # warn instead of silently reporting a bogus variance factor.
        import warnings

        warnings.warn(
            f"non-positive redundancy (n={n}, u={layout.u}): sigma0^2 "
            "clamped to v'Pv/1 — the adjustment is under-determined",
            stacklevel=2,
        )
    sigma02 = vPv / max(dof, 1)
    rms_x = float(np.sqrt(sx2 / problem.n_obs))
    rms_y = float(np.sqrt(sy2 / problem.n_obs))
    return DenseResult(
        problem=problem,
        layout=layout,
        x=np.asarray(x),
        iterations=count,
        converged=converged,
        delta_history=delta_history,
        x_history=np.asarray(history) if keep_history else np.zeros((0, layout.u)),
        v=v_np,
        sigma02=sigma02,
        rms_x=rms_x,
        rms_y=rms_y,
        rms=float(np.sqrt(rms_x**2 + rms_y**2)),
        Cx=None,
        std=None,
        Cx_q=None,
        elapsed_s=elapsed,
        stopped_on=stopped_on,
    )


def make_pair_plan(problem, layout, opts: SchurOptions, order):
    """Build the static observation-pair plan for the explicit dense-S path
    when it applies (see SchurOptions.explicit_s); None otherwise."""
    explicit = opts.explicit_s
    if explicit is None:
        explicit = (
            problem.n_img <= opts.explicit_s_max_images and order is not None
        )
    if not explicit or layout.n_eop == 0 or layout.n_tie == 0:
        return None
    if order is None:
        raise ValueError("explicit_s requires the tie-sorted obs order")
    from fish_eye_bundle_adjustment_tpu.solver.explicit import PairPlan

    tie = problem.target_tie_slot[problem.obs_pt]
    tie = np.where(tie >= 0, tie, layout.n_tie).astype(np.int64)[order]
    img = problem.obs_img[order]
    return PairPlan.build(tie, img, layout.n_tie, layout.n_img)


def solve_schur(
    problem: BAProblem,
    options: Optional[SchurOptions] = None,
    keep_history: bool = False,
    x0=None,
    progress_fn=None,
    checkpoint_path=None,
    checkpoint_every: int = 1,
    compute_covariance: bool = True,
) -> DenseResult:
    """Outer Gauss-Newton loop with the Schur/PCG inner solve (one device).

    Matches the reference's convergence conventions (L1 of the de-scaled
    correction vs Threshold_Value, Iteration_Cap).  Parameter stds come
    from the block covariance back-substitution in solver/covariance.py
    (dense-S materialization, gated by problem size — past the gate std
    stays None and the report prints n/a instead of numbers).
    """
    opts = options or SchurOptions()
    settings = problem.settings
    layout = ParamLayout(problem)
    use_ic = settings.inner_constraints
    if use_ic:
        validate_inner_constraints(layout)

    kernel = SchurKernel(layout, opts, obs_order=opts.obs_order)
    order = (
        ObsData.sort_order_by_tie(problem, layout)
        if opts.obs_order == "tie"
        else None  # problem order is image-major already ("img")
    )
    obs = ObsData.from_problem(
        problem, layout, dtype=opts.dtype, order=order,
        with_plan=order is not None,
    )
    pairs = make_pair_plan(problem, layout, opts, order)
    raw_step = schur_step_fn(kernel, layout, use_ic, pairs=pairs)
    use_device_loop = opts.device_loop
    if use_device_loop is None:
        use_device_loop = pairs is None and not keep_history
    if use_device_loop and pairs is None and not keep_history:
        from fish_eye_bundle_adjustment_tpu.solver.device_loop import (
            run_gn_loop_device,
        )

        (x, history, delta_history, v_local, stats, count, converged,
         elapsed, stopped_on) = run_gn_loop_device(
            raw_step, obs, layout, problem, opts, x0=x0,
            progress_fn=progress_fn, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, chunk=opts.device_chunk,
        )
    else:
        base_step = jax.jit(raw_step)
        step = lambda x, o, tol, lam: base_step(x, o, tol, lam, pairs)

        (x, history, delta_history, v_local, stats, count, converged,
         elapsed, stopped_on) = run_gn_loop(
            step, obs, layout, problem, opts,
            keep_history=keep_history, x0=x0, progress_fn=progress_fn,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
        )
    v_np = unpermute_v(v_local, order, problem.n_obs)
    result = _finalize(
        problem, layout, x, history, delta_history, v_np, np.asarray(stats),
        count, converged, elapsed, keep_history, stopped_on,
    )
    if compute_covariance:
        from fish_eye_bundle_adjustment_tpu.solver.covariance import (
            compute_stds,
        )

        std, Cc_q, method = compute_stds(
            problem, layout, result.x, result.sigma02
        )
        if std is not None:
            result.std = std
            result.Cc_q = Cc_q
            result.std_method = method
    return result
