"""Sharded camera-state distributed solver (SURVEY §2.5 row 2 — the BA
analogue of tensor parallelism).

parallel/dist_schur.py replicates all camera/point state and psums every
reduction: per-device memory for CG state and the pose preconditioner
grows with n_img regardless of device count.  This mode shards them:

- per-image pose blocks of the CG vectors (x, r, z, p), the reduced RHS,
  and the block-Jacobi preconditioner live SHARDED over the mesh — each
  device owns n_img/N images;
- pose-side observation reductions end in ``lax.psum_scatter`` (each
  device keeps only its image slice) instead of ``psum`` (everyone keeps
  everything);
- the only place the full pose vector materializes is the obs-side
  gather inside the S matvec — one ``all_gather`` per matvec, the
  minimal communication the observation access pattern requires;
- IOPs (n_cam * ni, tiny and touched by every observation) and the point
  factors (Hpp^-1) stay replicated;
- CG inner products weight the sharded pose part with a psum and add the
  replicated IOP part once.

Per-device camera-state memory vs the replicated path (f64 words):
  replicated:  ~6 CG vectors * (n_img*ne + n_cam*ni) + n_img*ne^2 precond
  sharded:     ~6 *(n_img*ne/N + n_cam*ni) + n_img*ne^2/N
               + one transient (n_img*ne) all_gather buffer per matvec
(see docs/PARITY.md for the worked 10k-image numbers).

Free-network inner constraints run projected like the replicated path;
each device holds only its own images' G rows.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from fish_eye_bundle_adjustment_tpu.io.problem import BAProblem
from fish_eye_bundle_adjustment_tpu.parallel.mesh import (
    OBS_AXIS, make_mesh, pad_to_multiple,
)
from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import shard_obs
from fish_eye_bundle_adjustment_tpu.solver.constraints import (
    build_G, validate_inner_constraints,
)
from fish_eye_bundle_adjustment_tpu.solver.dense import DenseResult
from fish_eye_bundle_adjustment_tpu.solver.schur import (
    ObsData,
    SchurKernel,
    SchurOptions,
    _expand_sym,
    _finalize,
    _pcg,
    _segsum,
    _stable_sum,
    run_gn_loop,
    step_precision,
    unpermute_v,
)
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

AX = OBS_AXIS  # one mesh axis serves both the obs shards and pose slices


def make_sharded_camera_step(problem: BAProblem, mesh,
                             options: Optional[SchurOptions] = None,
                             point_mode: str = "replicated"):
    """Build (step_fn, sharded_obs, layout, order).  Same contract as
    dist_schur.make_distributed_step — the full unknown vector stays
    replicated at the step boundary (so run_gn_loop and checkpointing are
    unchanged); the sharding lives inside the CG solve.

    point_mode="sharded" additionally shards the POINT state over the
    same mesh axis (parallel/tieshard.py): Hpp^-1 and every per-tie
    segment sum live as (n_tie/N)-sized local spans, with boundary ties
    completed by an O(N)-word exchange instead of full (n_tie, k) psums
    — SURVEY §2.5 row 2's camera+point block sharding."""
    opts = options or SchurOptions()
    layout = ParamLayout(problem)
    use_ic = problem.settings.inner_constraints
    if use_ic:
        validate_inner_constraints(layout)

    n_dev = int(np.prod(mesh.devices.shape))
    padded = pad_to_multiple(problem.n_obs, n_dev)
    order = (
        ObsData.sort_order_by_tie(problem, layout)
        if opts.obs_order == "tie"
        else None
    )
    obs = ObsData.from_problem(
        problem, layout, dtype=opts.dtype, pad_to=padded, order=order,
        with_plan=order is not None, shard_plans=n_dev,
    )
    obs = shard_obs(obs, mesh)

    ts = None
    if point_mode == "sharded":
        from fish_eye_bundle_adjustment_tpu.parallel import tieshard

        if order is None or layout.n_tie == 0:
            raise ValueError(
                "point_mode='sharded' needs the tie-sorted stream and "
                "tie points to shard"
            )
        tie = problem.target_tie_slot[problem.obs_pt]
        tie = np.where(tie >= 0, tie, layout.n_tie).astype(np.int64)
        tie_sorted = np.concatenate(
            [tie[order], np.full(padded - problem.n_obs, layout.n_tie,
                                 np.int64)]
        )
        ts = tieshard.build_tie_shard(tie_sorted, layout.n_tie, n_dev)
        ts = jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
            ts, tieshard.pspec(AX, ts),
        )
    elif point_mode != "replicated":
        raise ValueError(f"unknown point_mode {point_mode!r}")

    kernel = SchurKernel(
        layout, opts, reduce_fn=partial(jax.lax.psum, axis_name=AX),
        obs_order=opts.obs_order,
    )
    ne, ni = kernel.ne, kernel.ni
    n_img, n_cam = kernel.n_img, kernel.n_cam
    n_img_pad = pad_to_multiple(max(n_img, 1), n_dev)
    m_loc = n_img_pad // n_dev  # images per device
    iop_len = n_cam * ni
    scale = jnp.asarray(layout.scale, dtype=opts.dtype)

    if ne == 0:
        raise ValueError(
            "sharded camera state requires per-image EOP unknowns; "
            "use solve_schur_distributed for IOP/tie-only problems"
        )

    tie_sharded = point_mode == "sharded"
    adaptive = opts.adaptive_damping

    def body(x, obs_l: ObsData, ts_l, cg_tol, lam):
        with step_precision():
            return _body(x, obs_l, ts_l, cg_tol, lam)

    def _body(x, obs_l, ts_l, cg_tol, lam):
        q = x * scale
        lam_t = lam if adaptive else None
        wx, wy = obs_l.W[:, 0], obs_l.W[:, 1]
        if tie_sharded:
            # local point state: Hpp built/inverted over this device's
            # contiguous tie span, boundary ties completed by the O(N)
            # exchange (parallel/tieshard.py); the SchurFactors view
            # carries LOCAL tie ids so its per-obs Hpi gathers (pose
            # preconditioner correction) hit the local table, with the
            # sentinel row L = exact zeros for control rows
            import dataclasses as _dc

            from fish_eye_bundle_adjustment_tpu.parallel.tieshard import (
                LocalTieOps,
            )
            from fish_eye_bundle_adjustment_tpu.solver.schur import (
                SchurFactors,
                _inv3x3,
            )

            lops = LocalTieOps(ts_l, AX)
            L = lops.L
            rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy = kernel.blocks(q, obs_l)
            cols = []
            for a_ in range(3):
                for b_ in range(a_, 3):
                    cols.append(
                        wx * Jpx[:, a_] * Jpx[:, b_]
                        + wy * Jpy[:, a_] * Jpy[:, b_]
                    )
            Hs = lops.segsum(jnp.stack(cols, 1))[:L]
            lam_fix = opts.point_damping + 1e-300
            i00, i01, i02, i11, i12, i22 = (Hs[:, j] for j in range(6))
            if lam_t is None:
                d0 = d1 = d2 = 0.0
            else:
                # clamped Marquardt diag (see SchurKernel.linearize)
                mx = jnp.maximum(jnp.maximum(i00, i11), i22)
                floor = jnp.maximum(1e-6 * mx, 1e-30)
                d0 = lam_t * jnp.maximum(i00, floor)
                d1 = lam_t * jnp.maximum(i11, floor)
                d2 = lam_t * jnp.maximum(i22, floor)
            Hpp = jnp.stack(
                [
                    jnp.stack([i00 + d0 + lam_fix, i01, i02], axis=1),
                    jnp.stack([i01, i11 + d1 + lam_fix, i12], axis=1),
                    jnp.stack([i02, i12, i22 + d2 + lam_fix], axis=1),
                ],
                axis=1,
            )
            Hpi_loc = jnp.concatenate(
                [_inv3x3(Hpp).reshape(L, 9), jnp.zeros((1, 9), q.dtype)], 0
            )
            obs_view = _dc.replace(obs_l, tie=lops.tie_local)
            fac = SchurFactors(
                kernel, obs_view, rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy,
                Hpi_loc,
            )

            def point_applyT(bx, by):
                tp = Jpx * bx[:, None] + Jpy * by[:, None]
                return lops.segsum(tp)  # (L+1, 3), boundary-complete

            def hpp_apply(t):
                H = Hpi_loc.reshape(L + 1, 3, 3)
                return jnp.einsum("tpq,tq->tp", H, t)  # dummy row -> 0

            def point_apply(yext):
                yg = yext[lops.tie_local]
                return jnp.sum(Jpx * yg, 1), jnp.sum(Jpy * yg, 1)
        else:
            lops = None
            fac = kernel.linearize(q, obs_l, lam=lam_t)  # Hpp psums inside
            point_applyT = fac._point_applyT
            hpp_apply = fac._hpp_inv_apply
            point_apply = fac._point_apply

        def img_scatter(cols):
            """Per-obs pose columns -> this device's image slice via
            partial segment-sum + psum_scatter."""
            if obs_l.plan is not None:
                part = obs_l.plan.secondary_sum(cols)  # (n_img, k) partial
            else:
                part = _segsum(cols, obs_l.img, n_img)
            if n_img_pad != n_img:
                part = jnp.concatenate(
                    [part, jnp.zeros((n_img_pad - n_img,) + part.shape[1:],
                                     part.dtype)], 0)
            return jax.lax.psum_scatter(
                part, AX, scatter_dimension=0, tiled=True
            )  # (m_loc, k)

        def iop_reduce(cols):
            if n_cam == 1:
                out = jnp.sum(cols, axis=0, keepdims=True)
            else:
                out = _segsum(cols, obs_l.cam, n_cam)
            return jax.lax.psum(out, AX)

        # ---- sharded block-Jacobi preconditioner ----------------------
        # pose diagonal of S (with the Hpp^-1 correction), per local image:
        # the shared per-observation sym columns (SchurFactors) reduced
        # into this device's image slice
        # adaptive-LM damping vector: raw diag(Hcc) (NOT diag(S) — see
        # SchurKernel.linearize), pose part reduced straight into this
        # device's image slice by the same psum_scatter the matvec uses
        if lam_t is not None:
            from fish_eye_bundle_adjustment_tpu.solver.schur import (
                _clamp_diag,
            )

            de = wx[:, None] * fac.Jex**2 + wy[:, None] * fac.Jey**2
            dcc_pose = _clamp_diag(img_scatter(de))  # (m_loc, ne)
            dcc_iop = (
                _clamp_diag(iop_reduce(
                    wx[:, None] * fac.Jix**2 + wy[:, None] * fac.Jiy**2
                ))
                if ni else jnp.zeros((n_cam, 0), q.dtype)
            )
        else:
            dcc_pose = dcc_iop = None
        pose_blocks = _expand_sym(img_scatter(fac.pose_precond_sym()), ne)
        # padded image slots have all-zero blocks: make them identity so
        # the inverse is finite (their CG rows are identically zero)
        empty = (jnp.abs(pose_blocks).sum((1, 2)) == 0)[:, None, None]
        eye = jnp.eye(ne, dtype=pose_blocks.dtype)
        if lam_t is not None:
            pose_blocks = pose_blocks + lam_t * dcc_pose[..., None] * eye
        pose_inv = jnp.linalg.inv(pose_blocks + jnp.where(empty, eye, 1e-300 * eye))
        if ni:
            iop_blocks = _expand_sym(iop_reduce(fac.iop_precond_sym()), ni)
            if lam_t is not None:
                iop_blocks = iop_blocks + (
                    lam_t * dcc_iop[..., None] * jnp.eye(ni, dtype=q.dtype)
                )
            iop_inv = jnp.linalg.inv(
                iop_blocks + 1e-300 * jnp.eye(ni, dtype=iop_blocks.dtype)
            )
        else:
            iop_inv = jnp.zeros((n_cam, 0, 0), q.dtype)

        def precond(v):
            vp, vi = v
            pz = jnp.einsum("bij,bj->bi", pose_inv, vp)
            iz = (
                jnp.einsum("bij,bj->bi", iop_inv, vi.reshape(n_cam, ni))
                .reshape(-1)
                if ni else vi
            )
            return (pz, iz)

        # ---- inner-constraint projection (local G rows) ----------------
        if use_ic:
            G = build_G(layout, q)[: kernel.nc]  # (nc, 7)
            Gp = G[: layout.eop_size].reshape(n_img, ne, -1)
            if n_img_pad != n_img:
                Gp = jnp.concatenate(
                    [Gp, jnp.zeros((n_img_pad - n_img, ne, G.shape[1]),
                                   G.dtype)], 0)
            d = jax.lax.axis_index(AX)
            Gp_loc = jax.lax.dynamic_slice_in_dim(Gp, d * m_loc, m_loc, 0)
            Gi = G[layout.eop_size :]
            GtG_inv = jnp.linalg.inv(G.T @ G)

            def project(v):
                vp, vi = v
                gtv = jax.lax.psum(
                    jnp.einsum("bed,be->d", Gp_loc, vp), AX
                ) + Gi.T @ vi
                coef = GtG_inv @ gtv
                return (
                    vp - jnp.einsum("bed,d->be", Gp_loc, coef),
                    vi - Gi @ coef,
                )
        else:
            def project(v):
                return v

        # ---- S matvec on (sharded pose, replicated iop) -----------------
        def matvec(v):
            vp_loc, vi = v
            vp_full = jax.lax.all_gather(
                vp_loc, AX, axis=0, tiled=True
            )[:n_img]  # (n_img, ne)
            vc = jnp.concatenate([vp_full.reshape(-1), vi])
            ax, ay = fac._cam_apply(vc)
            awx, awy = wx * ax, wy * ay
            if kernel.n_tie:
                t = point_applyT(awx, awy)  # full psum / boundary exchange
                y = hpp_apply(t)
                px, py = point_apply(y)
                awx = awx - wx * px
                awy = awy - wy * py
            out_p = img_scatter(
                fac.Jex * awx[:, None] + fac.Jey * awy[:, None]
            )
            if ni:
                out_i = iop_reduce(
                    fac.Jix * awx[:, None] + fac.Jiy * awy[:, None]
                ).reshape(-1)
            else:
                out_i = jnp.zeros((0,), q.dtype)
            if opts.camera_damping:
                out_p = out_p + opts.camera_damping * vp_loc
                out_i = out_i + opts.camera_damping * vi
            if lam_t is not None:
                out_p = out_p + lam_t * dcc_pose * vp_loc
                out_i = out_i + lam_t * dcc_iop.reshape(-1) * vi
            return (out_p, out_i)

        def dot(a, b):
            ap, ai = a
            bp, bi = b
            s = jax.lax.psum(jnp.vdot(ap, bp), AX)
            return s + jnp.vdot(ai, bi)

        # ---- reduced RHS -------------------------------------------------
        rwx, rwy = wx * fac.rx, wy * fac.ry
        if kernel.n_tie:
            t = point_applyT(rwx, rwy)
            y = hpp_apply(t)
            px, py = point_apply(y)
            rwx = rwx - wx * px
            rwy = rwy - wy * py
        rhs = (
            -img_scatter(fac.Jex * rwx[:, None] + fac.Jey * rwy[:, None]),
            -(iop_reduce(fac.Jix * rwx[:, None] + fac.Jiy * rwy[:, None])
              .reshape(-1) if ni else jnp.zeros((0,), q.dtype)),
        )

        dc_sh, cg_iters, _ = _pcg(
            matvec, rhs, precond, project, cg_tol, opts.cg_maxiter, dot=dot
        )
        dp_full = jax.lax.all_gather(dc_sh[0], AX, axis=0, tiled=True)[:n_img]
        dc = jnp.concatenate([dp_full.reshape(-1), dc_sh[1]])
        ax, ay = fac._cam_apply(dc)
        if kernel.n_tie:
            # back-substitution through the mode's point machinery; the
            # global (n_tie, 3) correction materializes exactly once per
            # step, at the replicated delta_q boundary
            rhs_p = point_applyT(wx * (fac.rx + ax), wy * (fac.ry + ay))
            dp_int = hpp_apply(-rhs_p)
            px, py = point_apply(dp_int)
            dp = (
                lops.gather_global(dp_int[: lops.L])
                if tie_sharded else dp_int
            )
        else:
            dp = jnp.zeros((0, 3), q.dtype)
            px = py = jnp.zeros_like(fac.rx)
        delta_q = jnp.concatenate([dc, dp.reshape(-1)])
        delta_x = delta_q / scale
        vx = jnp.where(wx > 0, ax + px + fac.rx, 0.0)
        vy = jnp.where(wy > 0, ay + py + fac.ry, 0.0)
        vPv = jax.lax.psum(_stable_sum(vx * vx * wx + vy * vy * wy), AX)
        sum_vx2 = jax.lax.psum(jnp.sum(vx * vx), AX)
        sum_vy2 = jax.lax.psum(jnp.sum(vy * vy), AX)
        rxm = jnp.where(wx > 0, fac.rx, 0.0)
        rym = jnp.where(wy > 0, fac.ry, 0.0)
        cost_old = jax.lax.psum(
            _stable_sum(wx * rxm**2 + wy * rym**2), AX
        )
        x_trial = x + delta_x
        # trial validated DEFERRED against the next step's cost_old
        stats = jnp.stack([vPv, sum_vx2, sum_vy2, cost_old])
        v_local = jnp.stack([vx, vy], axis=1)
        return x_trial, jnp.sum(jnp.abs(delta_x)), v_local, stats, cg_iters

    if tie_sharded:
        from fish_eye_bundle_adjustment_tpu.parallel import tieshard

        mapped = jax.jit(
            shard_map(
                body,
                mesh=mesh,
                in_specs=(P(), obs.pspec(AX), tieshard.pspec(AX, ts), P(), P()),
                out_specs=(P(), P(), P(AX), P(), P()),
                check_vma=False,
            )
        )
        step = lambda x, o, tol, lam: mapped(x, o, ts, tol, lam)
    else:
        step = jax.jit(
            shard_map(
                lambda x, o, tol, lam: body(x, o, None, tol, lam),
                mesh=mesh,
                in_specs=(P(), obs.pspec(AX), P(), P()),
                out_specs=(P(), P(), P(AX), P(), P()),
                check_vma=False,
            )
        )
    return step, obs, layout, order


def solve_schur_sharded_state(
    problem: BAProblem,
    mesh=None,
    options: Optional[SchurOptions] = None,
    keep_history: bool = False,
    x0=None,
    progress_fn=None,
    checkpoint_path=None,
    checkpoint_every: int = 1,
    compute_covariance: bool = False,
    point_mode: str = "replicated",
) -> DenseResult:
    """Drop-in distributed solve with sharded camera state (same result
    contract as solve_schur_distributed, stds included).

    `compute_covariance` defaults OFF (see solve_schur_distributed): the
    report-time covariance path runs single-device probe solves that can
    dominate at exactly the scales this solver targets — opt in.
    `point_mode="sharded"` also shards the tie/point state (Hpp^-1 and
    point segment sums ~ n_tie/N per device, boundary-only exchange)."""
    opts = options or SchurOptions()
    mesh = mesh if mesh is not None else make_mesh()
    step, obs, layout, order = make_sharded_camera_step(
        problem, mesh, opts, point_mode=point_mode
    )
    use_device_loop = opts.device_loop
    if use_device_loop is None:
        use_device_loop = not keep_history
    if use_device_loop and not keep_history:
        from fish_eye_bundle_adjustment_tpu.solver.device_loop import (
            run_gn_loop_device,
        )

        (x, history, delta_history, v_shard, stats, count, converged,
         elapsed, stopped_on) = run_gn_loop_device(
            step, obs, layout, problem, opts, x0=x0,
            progress_fn=progress_fn, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, chunk=opts.device_chunk,
        )
    else:
        (x, history, delta_history, v_shard, stats, count, converged,
         elapsed, stopped_on) = run_gn_loop(
            step, obs, layout, problem, opts,
            keep_history=keep_history, x0=x0, progress_fn=progress_fn,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
            x_sharding=NamedSharding(mesh, P()),
        )
    v_np = unpermute_v(v_shard, order, problem.n_obs)
    result = _finalize(
        problem, layout, x, history, delta_history, v_np, np.asarray(stats),
        count, converged, elapsed, keep_history, stopped_on,
    )
    if compute_covariance:
        # exact below the dense-S gate, Hutchinson estimate past it
        # (main.m:712-897 reports +-sigma for every unknown, always)
        from fish_eye_bundle_adjustment_tpu.solver.covariance import (
            compute_stds,
        )

        std, Cc_q, method = compute_stds(
            problem, layout, result.x, result.sigma02, mesh=mesh
        )
        if std is not None:
            result.std = std
            result.Cc_q = Cc_q
            result.std_method = method
    return result
