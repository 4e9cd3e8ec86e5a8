"""Diagnose an f32 stall at benchmark scale.

Runs the selfcal 1k-img block's GN iteration in f32 and decomposes
L1(delta) per parameter family (EOP positions, EOP angles, IOPs,
distortions, tie coords) per iteration, then repeats with float64
ACCUMULATION of the unknown vector (all stream work stays f32; only the
(u,) update x64 += delta runs in f64 — iterative-refinement-lite).

Hypothesis being tested: the stall is iterate-update round-off — x
entries are O(1e3) (positions / tie coords), so f32 ulp(x) ~ 6e-5-1e-4
per entry and deltas at/below that level cannot accumulate; L1 then
plateaus at ~u * ulp ~ 20-40, amplified by CG noise.

Usage: python bench_f32_convergence.py [--n-img 1000] [--n-pts 100000]
       [--cap 60]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=1000)
    ap.add_argument("--n-pts", type=int, default=100_000)
    ap.add_argument("--cap", type=int, default=60)
    ap.add_argument("--eop-tie", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData, SchurKernel, SchurOptions, schur_step_fn,
    )
    from fish_eye_bundle_adjustment_tpu.synth import make_block
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    overrides = {"inner_constraints": False}
    if not args.eop_tie:
        overrides.update(
            estimate_c=True, estimate_xp=True, estimate_yp=True,
            estimate_radial=True, estimate_decent=True,
        )
    blk = make_block(
        n_img=args.n_img, n_pts=args.n_pts, model="fisheye", seed=2,
        settings_overrides=overrides, control_frac=0.01,
    )
    problem = blk.problem
    layout = ParamLayout(problem)
    opts = SchurOptions(
        dtype=np.float32, cg_maxiter=40, cg_tol=1e-6, obs_order="tie"
    )
    kernel = SchurKernel(layout, opts, obs_order="tie")
    order = ObsData.sort_order_by_tie(problem, layout)
    obs = ObsData.from_problem(
        problem, layout, dtype=np.float32, order=order, with_plan=True
    )
    ne, ni = layout.n_eop, layout.n_iop
    n_img = problem.n_img
    eop_n = ne * n_img
    iop_n = ni * problem.n_cam

    # family masks over the unknown vector
    fam = np.zeros(layout.u, np.int32)  # 0 pos, 1 ang, 2 iop, 3 tie
    eop_cols = np.asarray(layout.eop_cols)
    for i in range(n_img):
        for local, c in enumerate(eop_cols):
            fam[i * ne + local] = 0 if c < 3 else 1
    fam[eop_n : eop_n + iop_n] = 2
    fam[eop_n + iop_n :] = 3

    raw = schur_step_fn(kernel, layout, False)

    @jax.jit
    def step64(x64, obs_, tol):
        x32 = x64.astype(jnp.float32)
        new_x, _, v, stats, cg = raw(x32, obs_, tol)
        delta = new_x.astype(jnp.float64) - x64.astype(jnp.float64)
        # f64 accumulation: the f32 step's *delta* applied to the f64 state
        return x64 + delta, delta.astype(jnp.float32), stats, cg

    @jax.jit
    def step32(x32, obs_, tol):
        new_x, _, v, stats, cg = raw(x32, obs_, tol)
        return new_x, (new_x - x32), stats, cg

    fam_dev = jnp.asarray(fam)

    @jax.jit
    def decompose(delta):
        a = jnp.abs(delta.astype(jnp.float32))
        return jnp.stack(
            [jnp.sum(jnp.where(fam_dev == k, a, 0.0)) for k in range(4)]
        )

    threshold = 3e-4 * layout.u
    for name, stepper, x0 in (
        ("f32   ", step32, jnp.asarray(layout.initial().astype(np.float32))),
        ("f64acc", step64, jnp.asarray(layout.initial().astype(np.float64))),
    ):
        x = x0
        cg_tol = 1e-2
        delta0 = None
        t0 = time.perf_counter()
        hit = None
        for it in range(1, args.cap + 1):
            x, delta, stats, cg = stepper(x, obs, jnp.asarray(cg_tol, np.float32))
            d = np.asarray(decompose(delta), np.float64)
            l1 = float(d.sum())
            delta0 = delta0 or max(l1, 1e-30)
            rel = l1 / delta0
            cg_tol = max(1e-6, min(1e-2, rel * rel))
            if it <= 6 or it % 10 == 0 or l1 <= threshold:
                print(f"{name} it={it:3d} L1={l1:10.4g} pos={d[0]:9.3g} "
                      f"ang={d[1]:9.3g} iop={d[2]:9.3g} tie={d[3]:9.3g} "
                      f"cg={int(cg)}")
            if l1 <= threshold and hit is None:
                hit = it
                break
        dt = time.perf_counter() - t0
        vPv = float(stats[0])
        sigma02 = vPv / (problem.n - layout.u)
        print(f"# {name}: {'CONVERGED' if hit else 'NOT CONVERGED'} "
              f"iters={hit or args.cap} L1={l1:.4g} thr={threshold:.4g} "
              f"sigma02={sigma02:.5f} {dt:.1f}s")


if __name__ == "__main__":
    main()
