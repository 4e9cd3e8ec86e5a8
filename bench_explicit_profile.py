"""Stage-level profile of the explicit dense-S GN step on one device.

Times, as separately jitted units at benchmark scale:
  linearize | coupling_factors | build_dense_S | 10 GEMV CG iters |
  back_substitute | whole step
to locate where the explicit step's time goes.

Usage: python bench_explicit_profile.py [--n-img 1000] [--n-pts 100000]
       [--selfcal]
"""

import argparse
import time

import numpy as np


def _sync(out):
    """Synchronize through a scalar device->host read of the first
    output leaf."""
    import jax
    import jax.numpy as jnp

    leaves = [x for x in jax.tree.leaves(out) if hasattr(x, "dtype")]
    float(jnp.sum(leaves[0]).astype(jnp.float32))


def timeit(fn, *args, reps=5, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        _sync(out)
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=1000)
    ap.add_argument("--n-pts", type=int, default=100_000)
    ap.add_argument("--selfcal", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from fish_eye_bundle_adjustment_tpu.solver.explicit import (
        build_dense_S,
        coupling_factors,
        dense_precond,
    )
    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData,
        SchurKernel,
        SchurOptions,
        make_pair_plan,
        schur_step_fn,
    )
    from fish_eye_bundle_adjustment_tpu.synth import make_block
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    dtype = np.float32
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
    opts = SchurOptions(dtype=dtype, cg_maxiter=10, obs_order="tie")
    kernel = SchurKernel(layout, opts, obs_order="tie")
    order = ObsData.sort_order_by_tie(problem, layout)
    obs = ObsData.from_problem(
        problem, layout, dtype=dtype, order=order, with_plan=True
    )
    t0 = time.perf_counter()
    pairs = make_pair_plan(problem, layout, opts, order)
    print(f"pair plan: {pairs.n_pairs} pairs, host build "
          f"{time.perf_counter()-t0:.1f}s")

    x0 = jnp.asarray(layout.initial().astype(dtype))
    scale = jnp.asarray(layout.scale, dtype=dtype)
    q = x0 * scale

    lin = jax.jit(lambda q, obs: kernel.linearize(q, obs))
    fac = lin(q, obs)
    print(f"linearize           {timeit(lin, q, obs)*1e3:9.2f} ms")

    cf = jax.jit(lambda q, obs: coupling_factors(kernel.linearize(q, obs))[0])
    print(f"  +coupling_factors {timeit(cf, q, obs)*1e3:9.2f} ms")

    bs = jax.jit(
        lambda q, obs, p: build_dense_S(kernel.linearize(q, obs), p)
    )
    S = bs(q, obs, pairs)
    print(f"  +build_dense_S    {timeit(bs, q, obs, pairs)*1e3:9.2f} ms")

    v = jnp.ones((kernel.nc,), dtype)

    def gemv10(S, v):
        def body(i, v):
            w = S @ v
            return w / jnp.maximum(jnp.max(jnp.abs(w)), 1e-30)
        return jax.lax.fori_loop(0, 10, body, v)

    g10 = jax.jit(gemv10)
    print(f"10x GEMV            {timeit(g10, S, v)*1e3:9.2f} ms")

    mf = jax.jit(lambda q, obs, v: kernel.linearize(q, obs).schur_matvec(v))
    print(f"1x matrix-free mv   {timeit(mf, q, obs, v)*1e3:9.2f} ms")

    bsub = jax.jit(lambda q, obs, v: kernel.linearize(q, obs).back_substitute(v))
    print(f"lin+back_subst      {timeit(bsub, q, obs, v)*1e3:9.2f} ms")

    step = jax.jit(schur_step_fn(kernel, layout, False, pairs=pairs))
    tol = jnp.asarray(1e-4, dtype)
    out = step(x0, obs, tol, 0.0, pairs)
    jax.block_until_ready(out)
    print(f"whole explicit step {timeit(step, x0, obs, tol, 0.0, pairs)*1e3:9.2f} ms")

    mstep = jax.jit(schur_step_fn(kernel, layout, False))
    out = mstep(x0, obs, tol)
    jax.block_until_ready(out)
    print(f"whole mat-free step {timeit(mstep, x0, obs, tol)*1e3:9.2f} ms")


if __name__ == "__main__":
    main()
