"""Parameter covariance for the Schur path — stds at scale.

The reference reports a standard deviation for every unknown from
Cx = sigma0^2 * N^-1 (or the bordered [N G; G' 0]^-1 — main.m:428-443,
712-897).  The Schur solver never materializes N, so this module computes
the same quantities from the block factors:

  camera block:   Cc = sigma0^2 * (S^-1  or  [S Gc; Gc' 0]^-1 top-left),
                  where S = Hcc - Hcp Hpp^-1 Hpc is the reduced camera
                  system (materialized DENSELY, once, at report time);
  point blocks:   Cp_t = sigma0^2 * (Hpp_t^-1 + Z_t' Cc Z_t),
                  Z_t = Hpp_t^-1-folded coupling columns of point t
                  (block back-substitution of the covariance).

Materializing S exploits the tie factorization (r5): the coupling term
Hcp Hpp^-1 Hpc = Ghat' Ghat with Ghat[(t,p),(i,e)] = sum_o (D_o R_t)[e,p]
(R = chol(Hpp^-1)) — ONE dense scatter per tie chunk followed by BLAS
GEMMs, covering the ee/ei/ii corrections in a single product; the point
variances are one quadratic form diag3(Hpp^-1 + K' Cc K) per tie chunk.
Everything is float64: the linearization and the per-observation Hcc and
coupling blocks run jitted on the default device; the dense S assembly,
its GEMMs and the inverse run in numpy on the host.

Complexity: GEMM flops ~ nc^2 * 3*n_tie (~n_img^3 at fixed density), S
is (6*n_img + n_cam*ni)^2 — gated by ``max_images`` (default 1000, a
gate tuned on an earlier accelerator that is yet to be measured on the
GPU; opt in higher explicitly).  Past the gate the
solver returns std=None and the report writes n/a rather than NaN
columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fish_eye_bundle_adjustment_tpu.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu.solver.constraints import build_G
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout


@dataclasses.dataclass
class SchurCovariance:
    std: np.ndarray  # (u,) sigma0-scaled, de-scaled to x units
    Cc_q: np.ndarray  # (nc, nc) camera-block covariance, q-space,
    #                   pre-sigma02 (for report correlations, like Cx_q)


def schur_covariance(
    problem: BAProblem,
    layout: ParamLayout,
    x: np.ndarray,
    sigma02: float,
    max_images: int = 1000,
) -> Optional[SchurCovariance]:
    """Covariance diagonal (stds) + camera-block covariance at solution x.

    Returns None when n_img exceeds `max_images`: cost scales
    ~n_img^3, and past the gate the deflated estimator (annotated in the
    report) is the default; `max_images` stays available as an opt-in.
    """
    if problem.n_img > max_images:
        return None

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData,
        SchurKernel,
        SchurOptions,
    )

    opts = SchurOptions(dtype=np.float64, obs_order="tie")
    kernel = SchurKernel(layout, opts, obs_order="tie")
    ne, ni = kernel.ne, kernel.ni
    n_img, n_cam, nt = kernel.n_img, kernel.n_cam, kernel.n_tie
    nc = kernel.nc
    use_ic = problem.settings.inner_constraints

    order = ObsData.sort_order_by_tie(problem, layout)
    obs = ObsData.from_problem(
        problem, layout, dtype=np.float64, order=order, with_plan=True
    )
    q = jnp.asarray(np.asarray(x, dtype=np.float64) * layout.scale)
    fac = jax.jit(kernel.linearize)(q, obs)

    wx, wy = obs.W[:, 0], obs.W[:, 1]
    tie_np = np.asarray(obs.tie)
    img_np = np.asarray(obs.img)
    cam_np = np.asarray(obs.cam)
    N = obs.n

    # ---- Hcc blocks (no Schur correction) ------------------------------
    # NB: fac/weights enter as ARGUMENTS — a zero-arg closure embeds the
    # ~1M-row streams as jaxpr constants and XLA spends minutes
    # constant-folding them at compile
    @jax.jit
    def hcc_blocks(fac, obs, wx, wy):
        out = {}
        if ne:
            cols = [
                wx * fac.Jex[:, e] * fac.Jex[:, f]
                + wy * fac.Jey[:, e] * fac.Jey[:, f]
                for e in range(ne) for f in range(ne)
            ]
            out["ee"] = obs.plan.secondary_sum(jnp.stack(cols, 1)).reshape(
                n_img, ne, ne
            )
        if ne and ni:
            cols = [
                wx * fac.Jex[:, e] * fac.Jix[:, i]
                + wy * fac.Jey[:, e] * fac.Jiy[:, i]
                for e in range(ne) for i in range(ni)
            ]
            out["ei"] = obs.plan.secondary_sum(jnp.stack(cols, 1)).reshape(
                n_img, ne, ni
            )
        if ni:
            g = jnp.stack(
                [
                    wx * fac.Jix[:, i] * fac.Jix[:, j]
                    + wy * fac.Jiy[:, i] * fac.Jiy[:, j]
                    for i in range(ni) for j in range(ni)
                ],
                1,
            )
            if n_cam == 1:
                out["ii"] = jnp.sum(g, 0).reshape(1, ni, ni)
            else:
                out["ii"] = (
                    jnp.zeros((n_cam, ni * ni)).at[obs.cam].add(g)
                ).reshape(n_cam, ni, ni)
        return out

    hcc = {k: np.asarray(v) for k, v in hcc_blocks(fac, obs, wx, wy).items()}

    # ---- per-observation coupling blocks -------------------------------
    # D_o = Je' W Jp (ne,3); E_o = Ji' W Jp (ni,3); folded G_o = D_o Hpp^-1
    @jax.jit
    def coupling(fac, wx, wy):  # Hpi/streams via fac (pytree arg)
        Hg = fac.Hpi_flat[fac.obs.tie].reshape(N, 3, 3)  # zero row for control obs
        Jpw_x = fac.Jpx * wx[:, None]
        Jpw_y = fac.Jpy * wy[:, None]
        out = {}
        if ne:
            Dx = jnp.einsum("ne,np->nep", fac.Jex, Jpw_x)
            Dy = jnp.einsum("ne,np->nep", fac.Jey, Jpw_y)
            D = Dx + Dy  # (N, ne, 3)
            out["D"] = D
            out["G"] = jnp.einsum("nep,npq->neq", D, Hg)
        if ni:
            Ex = jnp.einsum("ni,np->nip", fac.Jix, Jpw_x)
            Ey = jnp.einsum("ni,np->nip", fac.Jiy, Jpw_y)
            out["E"] = Ex + Ey  # (N, ni, 3)
        out["Hg"] = Hg
        return out

    cp = coupling(fac, wx, wy)
    Hpi = np.asarray(fac.Hpi_flat)[:nt].reshape(nt, 3, 3)

    # per-(tie, cam) IOP aggregates: Esum (nt, n_cam, ni, 3)
    Esum = np.zeros((nt, n_cam, ni, 3))
    EHsum = np.zeros_like(Esum)  # Esum @ Hpp^-1, used twice below
    if ni and nt:
        E_np = np.asarray(cp["E"])
        live = tie_np < nt
        key = tie_np[live] * n_cam + cam_np[live]
        flat = np.zeros((nt * n_cam, ni * 3))
        np.add.at(flat, key, E_np[live].reshape(-1, ni * 3))
        Esum = flat.reshape(nt, n_cam, ni, 3)
        EHsum = np.einsum("tcip,tpq->tciq", Esum, Hpi)

    # ---- assemble dense S on the host -----------------------------------
    S = np.zeros((nc, nc))
    if ne:
        ee = hcc["ee"]
        for i in range(n_img):
            S[i * ne : (i + 1) * ne, i * ne : (i + 1) * ne] = ee[i]
    io = layout.eop_size  # offset of the IOP block inside the camera vector
    if ne and ni:
        ei = hcc["ei"]
        for i in range(n_img):
            c = int(problem.img_cam[i])
            S[i * ne : (i + 1) * ne, io + c * ni : io + (c + 1) * ni] += ei[i]
            S[io + c * ni : io + (c + 1) * ni, i * ne : (i + 1) * ne] += ei[i].T
    if ni:
        ii = hcc["ii"]
        for c in range(n_cam):
            S[io + c * ni : io + (c + 1) * ni, io + c * ni : io + (c + 1) * ni] = ii[c]

    # ---- Schur correction U = G_hat' G_hat as chunked dense BLAS GEMMs --
    # Enumerating observation PAIRS costs one gather per pair plus a
    # (P, 36) scatter per chunk.  But the correction Hcp Hpp^-1 Hpc factorizes per tie:
    #     U[(i,e),(j,f)] = sum_t  Ghat_t' Ghat_t,
    #     Ghat[(t,p), (i,e)] = sum_{o: tie=t, img=i} (D_o R_t)[e, p]
    # with Hpp^-1 = R R' (Cholesky), extended with the folded IOP columns
    # (Esum R) — ONE (3*chunk, nc) dense scatter per tie chunk (each
    # observation hits exactly one cell) followed by a BLAS syrk/gemm.
    # Covers the ee, ei, AND ii corrections in one product; ~nc^2*3*nt
    # FLOPs = dense-linear-algebra rates instead of per-pair gathers.
    tie_chunk = max(1, min(nt, 16384)) if nt else 1
    # contiguous row ranges per chunk (the stream is tie-sorted)
    starts = np.searchsorted(tie_np, np.arange(0, nt + 1)) if nt else None
    R = np.linalg.cholesky(Hpi) if nt else None  # (nt, 3, 3) lower
    D_np = np.asarray(cp["D"]) if ne else None
    if nt:
        live = tie_np < nt
        Rg = np.zeros((N, 3, 3))
        Rg[live] = R[tie_np[live]]
        M = (
            np.einsum("nep,npq->neq", D_np, Rg) if ne
            else np.zeros((N, 0, 3))
        )  # (N, ne, 3): D_a Hpp^-1 D_b' = M_a M_b'
        EsumR = (
            np.einsum("tcip,tpq->tciq", Esum, R) if ni
            else None
        )
        U = np.zeros((nc, nc))
        ar_e = np.arange(ne)
        for t0 in range(0, nt, tie_chunk):
            t1 = min(t0 + tie_chunk, nt)
            c = t1 - t0
            r0, r1 = int(starts[t0]), int(starts[t1])
            Gh = np.zeros((3 * c, nc))
            if ne and r1 > r0:
                rows = (3 * (tie_np[r0:r1] - t0))[:, None, None] + np.arange(3)[None, None, :]
                colsx = (img_np[r0:r1, None, None] * ne + ar_e[None, :, None])
                np.add.at(
                    Gh,
                    (rows * np.ones((1, ne, 1), np.int64),
                     colsx * np.ones((1, 1, 3), np.int64)),
                    M[r0:r1],
                )
            if ni:
                # folded IOP columns: Gh[3(t-t0)+q, io + c*ni + i]
                blockv = EsumR[t0:t1]  # (c, n_cam, ni, 3)
                for cam_i in range(n_cam):
                    view = Gh[:, io + cam_i * ni : io + (cam_i + 1) * ni]
                    view.reshape(c, 3, ni)[...] += blockv[:, cam_i].transpose(
                        0, 2, 1
                    )
            U += Gh.T @ Gh
        S -= U

    # ---- invert (host, f64) ---------------------------------------------
    if use_ic:
        Gc = np.asarray(build_G(layout, q))[:nc]  # (nc, 7); tie rows are zero
        d = Gc.shape[1]
        K = np.block([[S, Gc], [Gc.T, np.zeros((d, d))]])
        Cc = np.linalg.inv(K)[:nc, :nc]
    else:
        Cc = np.linalg.inv(S)

    # ---- stds ------------------------------------------------------------
    var_q = np.zeros(layout.u)
    var_q[:nc] = np.diag(Cc)
    if nt:
        # pvar_t = diag3(Hpp^-1 + K_t' Cc K_t) with K_t the full camera-
        # to-point coupling (pose columns G_o = D_o Hpp^-1, IOP columns
        # EHsum) — ONE quadratic form replaces r4's three pair passes
        # (pose-pair term via Cee, 2x cross term via Cei, IOP term via
        # Cii).  Same chunked scatter-then-GEMM shape as U above.
        pvar = np.einsum("tpp->tp", Hpi).copy()  # (nt, 3) base Hpp^-1 diag
        G_np = np.asarray(cp["G"]) if ne else None
        ar_e = np.arange(ne)
        for t0 in range(0, nt, tie_chunk):
            t1 = min(t0 + tie_chunk, nt)
            c = t1 - t0
            r0, r1 = int(starts[t0]), int(starts[t1])
            Kh = np.zeros((3 * c, nc))
            if ne and r1 > r0:
                rows = (3 * (tie_np[r0:r1] - t0))[:, None, None] + np.arange(3)[None, None, :]
                colsx = (img_np[r0:r1, None, None] * ne + ar_e[None, :, None])
                np.add.at(
                    Kh,
                    (rows * np.ones((1, ne, 1), np.int64),
                     colsx * np.ones((1, 1, 3), np.int64)),
                    G_np[r0:r1],
                )
            if ni:
                blockv = EHsum[t0:t1]  # (c, n_cam, ni, 3)
                for cam_i in range(n_cam):
                    view = Kh[:, io + cam_i * ni : io + (cam_i + 1) * ni]
                    view.reshape(c, 3, ni)[...] += blockv[:, cam_i].transpose(
                        0, 2, 1
                    )
            T = Kh @ Cc  # (3c, nc) BLAS
            pvar[t0:t1] += np.einsum("rn,rn->r", Kh, T).reshape(c, 3)
        var_q[layout.tie_offset :] = pvar.reshape(-1)

    var_x = var_q / layout.scale**2 * sigma02
    std = np.sqrt(np.maximum(var_x, 0.0))
    return SchurCovariance(std=std, Cc_q=Cc)


# ---------------------------------------------------------------------------
# Selected-diagonal estimation past the dense-S gate (stds at scale)
# ---------------------------------------------------------------------------

def estimate_schur_stds(
    problem: BAProblem,
    layout: ParamLayout,
    x: np.ndarray,
    sigma02: float,
    n_probe: int = 64,
    seed: int = 0,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 400,
    dtype=np.float32,
    mesh=None,
) -> np.ndarray:
    """Hutchinson estimate of every unknown's standard deviation.

    The reference reports +-sigma for every unknown unconditionally
    (main.m:712-897); past the dense-S gate this estimates diag(N^-1)
    with Rademacher probes through the matrix-free Schur machinery.
    With K = Hcp Hpp^-1, the blocks of N^-1 are

        camera:  Cc = S^-1          points:  Hpp^-1 + K' Cc K

    and the probes are SPLIT per block (ec with ep=0, and ep with ec=0):
    a joint probe's cross terms (ep' K' Cc ec etc.) have zero mean but
    dominate the estimator's variance.  Each half additionally subtracts
    an exact control variate so only genuinely unknown mass is sampled:

        camera probes:  d .* ec .* (Cc w - M w)     + exact diag(M),
                        w = ec ./ d,  d = sqrt(diag(M))
        point  probes:  ep .* (K' Cc K ep)          + exact diag(Hpp^-1)

    (M = the solver's block-Jacobi preconditioner; diag(Hpp^-1) is free
    from the factor's Hpi table).  The camera probes are IMPORTANCE-
    SCALED by d: camera variances span ~8 orders of magnitude (angle
    entries ~1e-8 x position entries), and an unscaled probe's absolute
    noise — set by the largest coupled entries — swamps the small
    diagonals (the round-3 zero-clipping failure).  Probing Cc through
    w = e/d and reading d .* e .* z makes the per-entry RELATIVE error
    uniform, ~sqrt(sum_k rho_jk^2 / n_probe) in the correlations rho.
    The point base term is exact and positive, so point estimates clip
    only when the sampled correction goes below -diag(Hpp^-1)
    (tests/test_estimated_stds measures the error distribution on a
    996-unknown block).  With inner constraints the probe solves run
    projected onto Null(G'), matching the minimum-norm (free-network)
    covariance.

    Cost: n_probe PCG solves at report time (half per block) —
    independent of the GN iteration count and embarrassingly parallel
    across probes.  With `mesh`, the probe solves run SPMD over it
    (obs-sharded shard_map, the dist_schur scheme) instead of rebuilding
    the problem on one device — the distributed solvers pass their own
    mesh.  The probe solves run f32 under solver.schur.step_precision().
    """
    from fish_eye_bundle_adjustment_tpu.solver.schur import step_precision

    with step_precision():
        return _estimate_schur_stds(
            problem, layout, x, sigma02, n_probe, seed, cg_tol, cg_maxiter,
            dtype, mesh,
        )


def _estimate_schur_stds(problem, layout, x, sigma02, n_probe, seed, cg_tol,
                         cg_maxiter, dtype, mesh):
    from jax import shard_map

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData,
        SchurKernel,
        SchurOptions,
        _pcg,
        make_projection_builder,
    )

    opts = SchurOptions(dtype=dtype, obs_order="tie")
    if mesh is None:
        kernel = SchurKernel(layout, opts, obs_order="tie")
        order = ObsData.sort_order_by_tie(problem, layout)
        obs = ObsData.from_problem(
            problem, layout, dtype=dtype, order=order, with_plan=True
        )
    else:
        from functools import partial as _partial

        from fish_eye_bundle_adjustment_tpu.parallel.mesh import (
            OBS_AXIS,
            pad_to_multiple,
        )
        from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import (
            shard_obs,
        )

        n_dev = int(np.prod(mesh.devices.shape))
        order = ObsData.sort_order_by_tie(problem, layout)
        obs = ObsData.from_problem(
            problem, layout, dtype=dtype,
            pad_to=pad_to_multiple(problem.n_obs, n_dev), order=order,
            with_plan=True, shard_plans=n_dev,
        )
        obs = shard_obs(obs, mesh)
        kernel = SchurKernel(
            layout, opts,
            reduce_fn=_partial(jax.lax.psum, axis_name=OBS_AXIS),
            obs_order="tie",
        )
    use_ic = problem.settings.inner_constraints
    q = jnp.asarray((np.asarray(x) * layout.scale).astype(dtype))
    nc, nt = kernel.nc, kernel.n_tie
    project_builder = make_projection_builder(layout, nc, use_ic)

    def solve_probe(q, obs, ec, ep, V):
        """One probe through N^-1.  Returns the CONTROL-VARIATE-REDUCED
        pair (zc - M ec, zp - Hpp^-1 ep); with ep = 0 the first entry
        samples the camera block, with ec = 0 the second samples the
        point-block correction K' Cc K ep (y0 = Hpp^-1 ep cancels).

        `V` (nc, k) is the DEFLATION basis: the CG right-hand side is
        projected onto its orthogonal complement, so the probe samples
        Cc (I - VV') — the globally-correlated subspace handled exactly
        elsewhere (pass zeros to sample the full operator)."""
        fac = kernel.linearize(q, obs)
        project = project_builder(q)
        precond = fac.make_preconditioner()[0]
        wx, wy = fac._w
        if nt:
            y0 = fac._hpp_inv_apply(ep)
            px, py = fac._point_apply(y0)
            rhs = ec - fac._cam_applyT(wx * px, wy * py)
        else:
            rhs = ec
        rhs = rhs - V @ (V.T @ rhs)
        zc, _, _ = _pcg(
            fac.schur_matvec, rhs, precond, project, cg_tol, cg_maxiter
        )
        if nt:
            ax, ay = fac._cam_apply(zc)
            t = fac._point_applyT(wx * ax, wy * ay)
            # (zp - y0) = K' Cc K ep for ec = 0
            zp_corr = -fac._hpp_inv_apply(t)
        else:
            zp_corr = jnp.zeros((0, 3), zc.dtype)
        return zc - precond(ec), zp_corr

    def bt_apply(q, obs, v):
        """B' v with B = the camera->point coupling (K' v in the module
        notation): the exact deflated part of the point correction."""
        fac = kernel.linearize(q, obs)
        wx, wy = fac._w
        if not nt:
            return jnp.zeros((0, 3), v.dtype)
        ax, ay = fac._cam_apply(v)
        t = fac._point_applyT(wx * ax, wy * ay)
        return -fac._hpp_inv_apply(t)

    def precond_apply(q, obs, v):
        fac = kernel.linearize(q, obs)
        return fac.make_preconditioner()[0](v)

    def hpp_inv_diag(q, obs):
        fac = kernel.linearize(q, obs)
        return fac.Hpi_flat[:nt][:, (0, 4, 8)]  # (nt, 3) exact diag

    if mesh is None:
        jitted = jax.jit(solve_probe)
        btap = jax.jit(bt_apply)
        papply = jax.jit(precond_apply)
        hdiag = jax.jit(hpp_inv_diag)
    else:
        from jax.sharding import PartitionSpec as P

        from fish_eye_bundle_adjustment_tpu.parallel.mesh import OBS_AXIS

        spec = obs.pspec(OBS_AXIS)
        jitted = jax.jit(shard_map(
            solve_probe, mesh=mesh, in_specs=(P(), spec, P(), P(), P()),
            out_specs=(P(), P()), check_vma=False,
        ))
        btap = jax.jit(shard_map(
            bt_apply, mesh=mesh, in_specs=(P(), spec, P()),
            out_specs=P(), check_vma=False,
        ))
        papply = jax.jit(shard_map(
            precond_apply, mesh=mesh, in_specs=(P(), spec, P()),
            out_specs=P(), check_vma=False,
        ))
        hdiag = jax.jit(shard_map(
            hpp_inv_diag, mesh=mesh, in_specs=(P(), spec),
            out_specs=P(), check_vma=False,
        ))

    # exact diag of the block-Jacobi M: apply M to per-block-position
    # indicator patterns (ne patterns cover every pose block at once,
    # ni patterns the IOP blocks)
    ne_, ni_ = kernel.ne, kernel.ni
    n_img_, n_cam_ = kernel.n_img, kernel.n_cam
    diagM = np.zeros(nc)
    for j in range(max(ne_, ni_)):
        pat = np.zeros(nc, dtype)
        if j < ne_:
            pat[j: n_img_ * ne_: ne_] = 1.0
        if j < ni_:
            pat[n_img_ * ne_ + j:: ni_] = 1.0
        out = np.asarray(papply(q, obs, jnp.asarray(pat)), np.float64)
        diagM += np.asarray(pat, np.float64) * out

    rng = np.random.default_rng(seed)
    zero_c = jnp.zeros(nc, dtype)
    zero_p = jnp.zeros((nt, 3), dtype)
    d = np.sqrt(np.maximum(diagM, 1e-300))  # importance scale (see docstring)

    # ---- DEFLATION of the globally-correlated subspace -----------------
    # The Monte-Carlo error is set by the covariance correlations between
    # simultaneously-probed entries, and in a bundle block with a weak
    # datum those are GLOBAL: the near-gauge modes (block translation/
    # rotation/scale against a handful of control points) give S^-1 a
    # dominant low-rank part with |rho| ~ 1 across the whole block, which
    # no sampling budget averages away (measured: q90 rel err 25-43% at
    # 64 probes; spatial-coloring probes fail for the same reason).
    # Remedy: build V ~ the dominant k-dim eigenspace of S^-1 by inverse
    # subspace iteration (each application = one CG solve), then use the
    # EXACT identity  Cc = Cc V V' + Cc (I - VV'):
    #     diag(Cc V V') = sum_k (Cc V)[:,k] * V[:,k]   (exact, from CV)
    # and sample only the deflated remainder, whose correlations are the
    # small local ones.  The point correction B' Cc B splits the same
    # way with B'V / B'(Cc V) computed exactly.
    k_defl = int(min(16, max(nc // 4, 0)))
    subspace_iters = 2
    diag_defl_c = np.zeros(nc)
    diag_defl_p = np.zeros((nt, 3))
    V_np = np.zeros((nc, max(k_defl, 1)))
    V_zero = jnp.zeros((nc, max(k_defl, 1)), dtype)

    def cc_apply(v_np, V_arg):
        """Cc (I - V V') v via one CG solve (+ M v control variate undo)."""
        v_j = jnp.asarray(v_np.astype(dtype))
        zc, _ = jitted(q, obs, v_j, zero_p, V_arg)
        return np.asarray(zc, np.float64) + np.asarray(
            papply(q, obs, v_j), np.float64
        )

    if k_defl >= 2:
        V_np, _ = np.linalg.qr(rng.normal(size=(nc, k_defl)))
        for _ in range(subspace_iters):
            Z = np.stack(
                [cc_apply(V_np[:, j], V_zero) for j in range(k_defl)], 1
            )
            V_np, _ = np.linalg.qr(Z)
        CV = np.stack(
            [cc_apply(V_np[:, j], V_zero) for j in range(k_defl)], 1
        )
        diag_defl_c = np.einsum("ik,ik->i", CV, V_np)
        if nt:
            BtV = np.stack(
                [np.asarray(btap(q, obs, jnp.asarray(
                    V_np[:, j].astype(dtype))), np.float64)
                 for j in range(k_defl)], 2,
            )  # (nt, 3, k)
            BtCV = np.stack(
                [np.asarray(btap(q, obs, jnp.asarray(
                    CV[:, j].astype(dtype))), np.float64)
                 for j in range(k_defl)], 2,
            )
            diag_defl_p = np.einsum("tpk,tpk->tp", BtV, BtCV)
    V_dev = jnp.asarray(V_np.astype(dtype))

    n_cam_probes = n_probe - n_probe // 2 if nt else n_probe
    n_pt_probes = n_probe - n_cam_probes
    acc_c = np.zeros(nc)
    for _ in range(n_cam_probes):
        e = (rng.integers(0, 2, nc) * 2 - 1).astype(np.float64)
        w = (e / d).astype(dtype)
        zc, _ = jitted(q, obs, jnp.asarray(w), zero_p, V_dev)
        acc_c += d * e * np.asarray(zc, np.float64)
    acc_p = np.zeros((nt, 3))
    for _ in range(n_pt_probes):
        e = (rng.integers(0, 2, (nt, 3)) * 2 - 1).astype(dtype)
        _, zp_corr = jitted(q, obs, zero_c, jnp.asarray(e), V_dev)
        acc_p += e.astype(np.float64) * np.asarray(zp_corr, np.float64)
    var_q = np.zeros(layout.u)
    var_q[:nc] = acc_c / max(n_cam_probes, 1) + diag_defl_c + diagM
    if nt:
        base_p = np.asarray(hdiag(q, obs), np.float64)
        var_q[layout.tie_offset:] = (
            acc_p / max(n_pt_probes, 1) + diag_defl_p + base_p
        ).reshape(-1)
    var_x = var_q / layout.scale**2 * sigma02
    return np.sqrt(np.maximum(var_x, 0.0))


def compute_stds(
    problem: BAProblem,
    layout: ParamLayout,
    x: np.ndarray,
    sigma02: float,
    max_images: int = 1000,
    n_probe: int = 64,
    mesh=None,
):
    """Stds for every unknown: exact block covariance below the dense-S
    gate, Hutchinson estimate past it (the reference always reports
    +-sigma, main.m:712-897).  Returns (std, Cc_q or None, method).
    `mesh` (from a distributed solver) runs the probe solves SPMD."""
    cov = schur_covariance(problem, layout, x, sigma02,
                           max_images=max_images)
    if cov is not None:
        return cov.std, cov.Cc_q, "exact"
    if n_probe:
        std = estimate_schur_stds(
            problem, layout, x, sigma02, n_probe=n_probe, mesh=mesh
        )
        return std, None, "hutchinson"
    return None, None, None
