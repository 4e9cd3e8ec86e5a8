"""Linearize-stage breakdown of the f32 GN step on one device.

Times: the full linearization, the Jacobian blocks (vmap jacfwd), the
sym6 tie reduction, and the EOP / point gathers feeding the blocks.

Usage: python bench_linearize.py [--selfcal]
"""

import argparse
import time

import numpy as np


def timeit(fn, *args, reps=10, warmup=2):
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=1000)
    ap.add_argument("--n-pts", type=int, default=100_000)
    ap.add_argument("--selfcal", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData, SchurKernel, SchurOptions,
    )
    from fish_eye_bundle_adjustment_tpu.synth import make_block
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    overrides = {"inner_constraints": False}
    if args.selfcal:
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
    opts = SchurOptions(dtype=np.float32, obs_order="tie")
    kernel = SchurKernel(layout, opts, obs_order="tie")
    obs = ObsData.from_problem(
        problem, layout, dtype=np.float32,
        order=ObsData.sort_order_by_tie(problem, layout), with_plan=True,
    )
    q = jnp.asarray((layout.initial() * layout.scale).astype(np.float32))

    lin = jax.jit(kernel.linearize)
    print(f"full linearize:        {timeit(lambda: lin(q, obs))*1e3:7.2f} ms")

    blocks = jax.jit(kernel.blocks)
    print(f"blocks (vmap jacfwd):  {timeit(lambda: blocks(q, obs))*1e3:7.2f} ms")

    outs = blocks(q, obs)

    @jax.jit
    def sym6_hpp(rxall):
        rx, ry, Jex, Jey, Jix, Jiy, Jpx, Jpy = rxall
        wx, wy = obs.W[:, 0], obs.W[:, 1]
        cols = []
        for a in range(3):
            for b in range(a, 3):
                cols.append(wx * Jpx[:, a] * Jpx[:, b] + wy * Jpy[:, a] * Jpy[:, b])
        sym6 = jnp.stack(cols, axis=1)
        return obs.plan.primary_sum(sym6)

    print(f"sym6 + tie segsum:     {timeit(lambda: sym6_hpp(outs))*1e3:7.2f} ms")

    # gathers feeding blocks()
    eop, iop, pts = layout.unpack_scaled(q)
    eopj = jnp.asarray(eop)
    ptsj = jnp.asarray(pts)
    g1 = jax.jit(lambda: eopj[obs.img])
    print(f"eop gather (N,6):      {timeit(g1)*1e3:7.2f} ms")
    g2 = jax.jit(lambda: ptsj[obs.pt])
    print(f"pts gather (N,3):      {timeit(g2)*1e3:7.2f} ms")


if __name__ == "__main__":
    main()
