"""Component-level profile of the Schur GN step on one device.

Times each stage of the step (linearize, preconditioner, reduced RHS, one
S matvec, back-substitution) plus the primitive ops that dominate them
(row gathers, sorted segment sums) so kernel work targets measured cost,
not guesses.

Usage: python bench_profile.py [--n-img 1000] [--n-pts 100000] [--f64]
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
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--selfcal", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData, SchurKernel, SchurOptions, schur_step_fn,
    )
    from fish_eye_bundle_adjustment_tpu.synth import make_block
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    dtype = np.float64 if args.f64 else np.float32
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
    opts = SchurOptions(dtype=dtype, cg_maxiter=10, cg_tol=1e-6, obs_order="tie")
    kernel = SchurKernel(layout, opts, obs_order="tie")
    order = ObsData.sort_order_by_tie(problem, layout)
    obs = ObsData.from_problem(problem, layout, dtype=dtype, order=order,
                               with_plan=True)
    N = obs.n
    print(f"# block: {problem.n_img} img / {problem.n_tie} tie / {N} obs / "
          f"u={layout.u}, dtype={np.dtype(dtype).name}")

    x0 = jnp.asarray(layout.initial().astype(dtype))
    scale = jnp.asarray(layout.scale, dtype=dtype)
    q = x0 * scale

    # full step
    step = jax.jit(schur_step_fn(kernel, layout, False))
    t = timeit(lambda: step(x0, obs, jnp.asarray(1e-4, dtype)), reps=5)
    print(f"full GN step (10 CG):      {t*1e3:8.2f} ms")

    # linearize
    lin = jax.jit(kernel.linearize)
    fac = lin(q, obs)
    t = timeit(lambda: lin(q, obs), reps=5)
    print(f"linearize (blocks+Hpp):    {t*1e3:8.2f} ms")

    # preconditioner build
    pre = jax.jit(lambda f: f.make_preconditioner()[0](jnp.ones(kernel.nc, dtype)))
    t = timeit(lambda: pre(fac), reps=5)
    print(f"precond build+apply:       {t*1e3:8.2f} ms")

    # reduced rhs
    rhs_fn = jax.jit(lambda f: f.reduced_rhs())
    rhs = rhs_fn(fac)
    t = timeit(lambda: rhs_fn(fac), reps=5)
    print(f"reduced_rhs:               {t*1e3:8.2f} ms")

    # one S matvec
    mv = jax.jit(lambda f, v: f.schur_matvec(v))
    t = timeit(lambda: mv(fac, rhs), reps=10)
    print(f"S matvec:                  {t*1e3:8.2f} ms")

    # back-substitute
    bs = jax.jit(lambda f, v: f.back_substitute(v))
    t = timeit(lambda: bs(fac, rhs), reps=5)
    print(f"back_substitute:           {t*1e3:8.2f} ms")

    # ---- primitive op costs ------------------------------------------------
    key = jax.random.PRNGKey(0)
    vp = jax.random.normal(key, (kernel.n_img, 6), dtype)
    vt = jax.random.normal(key, (kernel.n_tie + 1, 3), dtype)
    vals6 = jax.random.normal(key, (N, 6), dtype)
    vals3 = jax.random.normal(key, (N, 3), dtype)

    g_img = jax.jit(lambda v: v[obs.img])
    t = timeit(lambda: g_img(vp), reps=10)
    print(f"gather (N,6) by img:       {t*1e3:8.2f} ms")

    g_tie = jax.jit(lambda v: v[obs.tie])
    t = timeit(lambda: g_tie(vt), reps=10)
    print(f"gather (N,3) by tie(sorted):{t*1e3:7.2f} ms")

    g_perm = jax.jit(lambda v: v[obs.plan.perm])
    t = timeit(lambda: g_perm(vals6), reps=10)
    print(f"gather (N,6) by perm:      {t*1e3:8.2f} ms")

    ss_p = jax.jit(lambda v: obs.plan.primary_sum(v))
    t = timeit(lambda: ss_p(vals3), reps=10)
    print(f"sorted segsum (N,3)->tie:  {t*1e3:8.2f} ms")

    ss_s = jax.jit(lambda v: obs.plan.secondary_sum(v))
    t = timeit(lambda: ss_s(vals6), reps=10)
    print(f"perm+segsum (N,6)->img:    {t*1e3:8.2f} ms")

    # elementwise read cost floor: one pass over an (N, 18) array
    big = jax.random.normal(key, (N, 18), dtype)
    ew = jax.jit(lambda v: jnp.sum(v * 2.0, axis=1))
    t = timeit(lambda: ew(big), reps=10)
    print(f"elementwise (N,18) pass:   {t*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
