"""Benchmark harness (prints ONE JSON line).

Headline metric: observations/s of the Schur-complement Gauss-Newton step
on the BASELINE.json single-device scale config — a 1k-image /
100k-tie-point synthetic equidistant-fisheye block (~1M image
observations) — in float32 with the production inexact-Newton settings
(10 CG iterations/step) and the production reduction path
(scatter-free DualAxisPlan, with_plan=True, as solve_schur ships).

vs_baseline = device obs/s divided by the same step on the host CPU
(float64, the reference-equivalent precision), measured in a CPU-pinned
subprocess on a smaller block and normalized per observation.

Secondary metrics in the same JSON object:
- gn_iterations_per_second + convergence evidence: the same f32 block is
  driven to its convergence plateau (L1(delta) under 3e-4/unknown) and
  sigma0^2 must come out ~1.
- the 5k-image f32 solve to convergence.

Every line names the device and, on a GPU, its power limit.  Without a
GPU only --quick runs (its numbers are labelled with the device they
came from).

Usage:
  python bench.py              # full benchmark (GPU)
  python bench.py --quick      # small shapes (smoke test)
  python bench.py --skip-cpu --skip-convergence
"""

import argparse
import json
import os
import subprocess
import sys
import time


SELFCAL = {
    "estimate_c": True,
    "estimate_xp": True,
    "estimate_yp": True,
    "estimate_radial": True,
    "estimate_decent": True,
}


def _build(n_img, n_pts, seed=2, selfcal=False):
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    overrides = {"inner_constraints": False}
    if selfcal:
        overrides.update(SELFCAL)
    blk = make_block(
        n_img=n_img,
        n_pts=n_pts,
        model="fisheye",
        seed=seed,
        settings_overrides=overrides,
        control_frac=0.01,
    )
    return blk.problem


def _make_step(problem, dtype, cg_maxiter=10, use_explicit=False):
    """The exact production configuration solve_schur uses: tie-sorted
    observations with the scatter-free DualAxisPlan reductions."""
    from dataclasses import replace as dataclasses_replace

    import jax
    import jax.numpy as jnp

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData,
        SchurKernel,
        SchurOptions,
        make_pair_plan,
        schur_step_fn,
    )
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    opts = SchurOptions(
        dtype=dtype, cg_maxiter=cg_maxiter, cg_tol=1e-6, obs_order="tie"
    )
    layout = ParamLayout(problem)
    kernel = SchurKernel(layout, opts, obs_order="tie")
    order = ObsData.sort_order_by_tie(problem, layout)
    obs = ObsData.from_problem(
        problem, layout, dtype=dtype, order=order, with_plan=True
    )
    # Headline uses the matrix-free stream matvec; the explicit dense-S
    # path is timed separately below.
    pairs = (
        make_pair_plan(
            problem, layout,
            dataclasses_replace(opts, explicit_s=True), order,
        )
        if use_explicit
        else None
    )
    raw = schur_step_fn(kernel, layout, False, pairs=pairs)
    if pairs is not None:
        jit_raw = jax.jit(raw)
        step = lambda x, obs_, tol: jit_raw(x, obs_, tol, 0.0, pairs)
    else:
        step = jax.jit(raw)
    x0 = jnp.asarray(layout.initial().astype(dtype))
    return step, x0, obs, layout


def _time_steps(step, x0, obs, dtype, steps=5):
    """Compile + time `steps` sequential GN steps (each host-synced)."""
    import jax.numpy as jnp

    tol = jnp.asarray(1e-4, dtype)
    out = step(x0, obs, tol)  # warmup/compile
    float(out[1])
    t0 = time.perf_counter()
    xs = x0
    for _ in range(steps):
        out = step(xs, obs, tol)
        xs = out[0]
        float(out[1])  # host sync every step (real workloads read this)
    return (time.perf_counter() - t0) / steps


def _device_loop(problem, layout, obs, cg_maxiter, threshold, cap):
    """Compile, then run the device-resident GN loop once warm; returns
    run_gn_loop_device's tuple."""
    import dataclasses

    import numpy as np

    from fish_eye_bundle_adjustment_tpu.solver.device_loop import (
        _make_chunk_fn, run_gn_loop_device,
    )
    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        SchurKernel, SchurOptions, schur_step_fn,
    )

    prob = dataclasses.replace(
        problem, settings=dataclasses.replace(
            problem.settings, threshold=threshold, iteration_cap=cap),
    )
    opts = SchurOptions(
        dtype=np.float32, cg_maxiter=cg_maxiter, cg_tol=1e-6,
        obs_order="tie",
    )
    kern = SchurKernel(layout, opts, obs_order="tie")
    raw = schur_step_fn(kern, layout, False)
    cfn = _make_chunk_fn(raw, opts, prob.settings, np.float32,
                         opts.device_chunk)
    run = lambda: run_gn_loop_device(  # noqa: E731
        raw, obs, layout, prob, opts, chunk_fn=cfn, chunk=opts.device_chunk,
    )
    run()  # compile
    return run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small smoke-test shapes")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--skip-convergence", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np

    from fish_eye_bundle_adjustment_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from fish_eye_bundle_adjustment_tpu.utils.device import (
        device_info, device_label,
    )

    enable_compile_cache()
    info = device_info()
    if info["platform"] != "gpu" and not args.quick:
        sys.exit(f"bench.py measures the GPU; found {info['platform']} "
                 "(use --quick for a labelled smoke run)")
    dev = device_label()
    print(f"# device: {dev}", file=sys.stderr)

    if args.quick:
        dev_shape, cpu_shape = (64, 2000), (32, 1000)
    else:
        dev_shape, cpu_shape = (1000, 100_000), (128, 10_000)

    # Headline: the full self-calibrating adjustment (the reference's
    # flagship stage-3 mode) — per-camera IOP/distortion unknowns are in
    # the measured hot loop.  The EOP+tie-only step is reported alongside.
    prob_dev = _build(*dev_shape, selfcal=True)
    step, x0, obs, layout = _make_step(prob_dev, np.float32)
    t_step = _time_steps(step, x0, obs, np.float32, steps=args.steps)
    print(
        f"# [{dev}] selfcal: {prob_dev.n_img} img / {prob_dev.n_tie} tie / "
        f"{prob_dev.n_obs} obs / u={layout.u}, f32 step = {t_step*1e3:.1f} ms "
        f"-> {prob_dev.n_obs / t_step:,.0f} obs/s",
        file=sys.stderr,
    )

    # Production loop: the device-resident GN driver (solver/
    # device_loop.py) — the full deferred-LM accept/reject + forcing +
    # stopping logic runs under lax.while_loop, one host sync per chunk.
    # This is what solve_schur executes by default; the per-step-synced
    # number above additionally pays one host round trip per iteration.
    cap = 20
    out = _device_loop(prob_dev, layout, obs, 10, 1e-12, cap)
    n_it, t_loop = out[5], out[7]
    t_dev = t_loop / max(n_it, 1)
    print(
        f"# [{dev}] selfcal device-resident loop: {n_it} iters in "
        f"{t_loop:.3f}s = {t_dev*1e3:.1f} ms/iter "
        f"-> {prob_dev.n_obs/t_dev:,.0f} obs/s",
        file=sys.stderr,
    )

    prob_eop = _build(*dev_shape, selfcal=False)
    estep, ex0, eobs, _elay = _make_step(prob_eop, np.float32)
    t_eop = _time_steps(estep, ex0, eobs, np.float32, steps=args.steps)
    eop_obs_s = prob_eop.n_obs / t_eop
    print(
        f"# [{dev}] eop+tie: f32 step = {t_eop*1e3:.1f} ms "
        f"-> {eop_obs_s:,.0f} obs/s",
        file=sys.stderr,
    )

    # explicit dense-S path (S materialized once/step, GEMV matvecs)
    xstep, xx0, xobs, _xlay = _make_step(
        prob_dev, np.float32, use_explicit=True
    )
    t_exp = _time_steps(xstep, xx0, xobs, np.float32, steps=3)
    print(f"# [{dev}] selfcal explicit-S: f32 step = {t_exp*1e3:.1f} ms",
          file=sys.stderr)

    # Headline = the production device-resident loop (what solve_schur
    # executes); the per-step-synced measurement is kept alongside.
    dev_obs_s = prob_dev.n_obs / t_dev
    result = {
        "metric": "selfcal_schur_gn_step_observations_per_second",
        "value": round(dev_obs_s, 1),
        "unit": "obs/s",
        "device": dev,
        "vs_baseline": None,
        "step_ms": round(t_dev * 1e3, 2),
        "loop_mode": "device_resident",
        "step_ms_synced": round(t_step * 1e3, 2),
        "eop_tie_observations_per_second": round(eop_obs_s, 1),
        "eop_tie_step_ms": round(t_eop * 1e3, 2),
        "explicit_s_step_ms": round(t_exp * 1e3, 2),
    }

    # f32 convergence at benchmark scale ----------------------------------
    # The throughput step caps CG at 10 iterations; converging the outer
    # GN iteration needs the inner solves to reach the forcing tolerance,
    # so the convergence run uses 40-CG steps through the device loop.
    if not args.skip_convergence:
        out = _device_loop(prob_dev, layout, obs, 40, 3e-4 * layout.u, 60)
        _, _, dh, _, stats_cv, iters, conv_flag, secs, stop_cv = out
        l1 = dh[-1] if dh else float("inf")
        sigma02 = float(stats_cv[0]) / (prob_dev.n - layout.u)
        it_s = iters / secs if secs > 0 else None
        converged = bool(conv_flag) and 0.8 < sigma02 < 1.2
        print(
            f"# [{dev}] convergence: {iters} GN iters in {secs:.1f}s "
            f"({it_s:.2f} it/s, {stop_cv}), sigma0^2={sigma02:.4f}, "
            f"L1={l1:.3g} ({'OK' if converged else 'NOT CONVERGED'})",
            file=sys.stderr,
        )
        result["gn_iterations_per_second"] = round(it_s, 3)
        result["f32_converged"] = bool(converged)
        result["f32_sigma02"] = round(sigma02, 5)

    # 5k-image f32 solve to convergence through solve_schur (adaptive LM,
    # CG curvature guard, plateau detection).
    if not args.skip_convergence and not args.quick:
        import dataclasses

        from fish_eye_bundle_adjustment_tpu.solver.schur import (
            SchurOptions, solve_schur,
        )
        from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

        p5 = _build(5000, 500_000, seed=11, selfcal=False)
        lay5 = ParamLayout(p5)
        p5 = dataclasses.replace(
            p5, settings=dataclasses.replace(
                p5.settings, threshold=3e-4 * lay5.u, iteration_cap=60),
        )
        t0 = time.perf_counter()
        r5 = solve_schur(
            p5, options=SchurOptions(dtype=np.float32, cg_maxiter=40,
                                     cg_tol=1e-6),
            keep_history=False, compute_covariance=False,
        )
        result["scale_convergence_5k"] = {
            "n_obs": int(p5.n_obs), "u": int(lay5.u),
            "converged": bool(r5.converged),
            "stopped_on": r5.stopped_on,
            "iterations": int(r5.iterations),
            "sigma02": round(float(r5.sigma02), 5),
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        print(
            f"# [{dev}] 5k convergence: {r5.iterations} iters "
            f"({r5.stopped_on}), sigma0^2={r5.sigma02:.5f}",
            file=sys.stderr,
        )

    # CPU baseline — a CPU-pinned subprocess (bench_cpu_baseline.py):
    # JAX_PLATFORMS=cpu in its environment keeps it off the card this
    # process holds; it takes median-of-9 with reject-and-rerun and
    # reports `suspect` only if consistency never materializes.
    if not args.skip_cpu:
        cmd = [
            sys.executable, "bench_cpu_baseline.py",
            "--n-img", str(cpu_shape[0]), "--n-pts", str(cpu_shape[1]),
        ]
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=1800, check=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        sys.stderr.write(proc.stderr)
        cpu = json.loads(proc.stdout.strip().splitlines()[-1])
        cpu_obs_s = cpu["obs_selfcal"] / (cpu["t_selfcal_ms"] / 1e3)
        ce_obs_s = cpu["obs_eop_tie"] / (cpu["t_eop_tie_ms"] / 1e3)
        print(
            f"# CPU baseline (subprocess): selfcal {cpu_obs_s:,.0f} "
            f"obs/s, eop+tie {ce_obs_s:,.0f} obs/s",
            file=sys.stderr,
        )
        result["vs_baseline"] = round(dev_obs_s / cpu_obs_s, 2)
        result["eop_tie_vs_baseline"] = round(eop_obs_s / ce_obs_s, 2)
        if cpu.get("suspect"):
            result["cpu_baseline_suspect"] = True

    print(json.dumps(result))


if __name__ == "__main__":
    main()
