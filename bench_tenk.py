"""BASELINE.json configs[5] 10k-image block on one device (prints ONE
JSON line).

Runs the 10k / 11.1M-obs block single-device through the f32 XLA
matrix-free path:

1. per-step wall time + observations/s (5 host-synced steps, 10-CG);
2. a CONVERGED adjustment (adaptive-LM + CG curvature guard + plateau
   detection, cg_maxiter=40), recording iterations, sigma0^2, stop
   reason, and wall time;
3. device memory stats where the backend exposes them.

Usage: python bench_tenk.py [--n-img 10000] [--n-pts 1000000]
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=10_000)
    ap.add_argument("--n-pts", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData, SchurKernel, SchurOptions, schur_step_fn, solve_schur,
    )
    from fish_eye_bundle_adjustment_tpu.synth import make_block
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    t0 = time.perf_counter()
    blk = make_block(
        n_img=args.n_img, n_pts=args.n_pts, model="fisheye", seed=args.seed,
        settings_overrides={"inner_constraints": False, "iteration_cap": 60},
        control_frac=0.01,
    )
    problem = blk.problem
    layout = ParamLayout(problem)
    print(f"# build: {time.perf_counter()-t0:.0f}s  {problem.n_img} img / "
          f"{problem.n_tie} tie / {problem.n_obs} obs / u={layout.u}",
          file=sys.stderr)

    opts = SchurOptions(dtype=np.float32, cg_maxiter=10, cg_tol=1e-6)
    kernel = SchurKernel(layout, opts, obs_order="tie")
    result = {
        "metric": "tenk_single_device",
        "block": {"n_img": problem.n_img, "n_tie": problem.n_tie,
                  "n_obs": problem.n_obs, "u": int(layout.u)},
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
    }
    obs = ObsData.from_problem(
        problem, layout, dtype=np.float32,
        order=ObsData.sort_order_by_tie(problem, layout), with_plan=True,
    )
    step = jax.jit(schur_step_fn(kernel, layout, False))
    x0 = jnp.asarray(layout.initial().astype(np.float32))
    tol = jnp.asarray(1e-4, np.float32)
    lam = jnp.asarray(0.0, np.float32)
    t0 = time.perf_counter()
    out = step(x0, obs, tol, lam)
    float(out[1])
    result["compile_s"] = round(time.perf_counter() - t0, 1)
    times = []
    xs = x0
    for _ in range(args.steps):
        t0 = time.perf_counter()
        out = step(xs, obs, tol, lam)
        xs = out[0]
        float(out[1])
        times.append(time.perf_counter() - t0)
    times.sort()
    t_step = times[len(times) // 2]
    result["step_ms"] = round(t_step * 1e3, 2)
    result["observations_per_second"] = round(problem.n_obs / t_step, 1)
    print(f"# step {t_step*1e3:.1f} ms -> "
          f"{problem.n_obs/t_step/1e6:.2f}M obs/s", file=sys.stderr)

    try:
        ms = jax.devices()[0].memory_stats()
        if ms:
            result["hbm_bytes_in_use"] = int(ms.get("bytes_in_use", 0))
            result["hbm_peak_bytes"] = int(
                ms.get("peak_bytes_in_use", 0))
    except Exception:
        pass

    # converged solve (f32 floor; plateau detection stops at the floor)
    p2 = dataclasses.replace(
        problem,
        settings=dataclasses.replace(
            problem.settings, threshold=3e-4 * layout.u),
    )
    sopts = SchurOptions(dtype=np.float32, cg_maxiter=40, cg_tol=1e-6)
    t0 = time.perf_counter()
    res = solve_schur(p2, options=sopts, keep_history=False,
                      compute_covariance=False)
    result["solve"] = {
        "converged": bool(res.converged),
        "stopped_on": res.stopped_on,
        "iterations": int(res.iterations),
        "sigma02": round(float(res.sigma02), 5),
        "final_delta_l1": round(float(res.delta_history[-1]), 2),
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    print(f"# solve: converged={res.converged} ({res.stopped_on}) "
          f"iters={res.iterations} sigma02={res.sigma02:.5f}",
          file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
