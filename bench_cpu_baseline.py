"""CPU f64 baseline measurement — pinned subprocess (prints ONE JSON line).

Runs as `python bench_cpu_baseline.py` in a fresh process pinned to the
CPU backend before any compile (bench.py also passes JAX_PLATFORMS=cpu in
its environment, so this child never opens the GPU its parent holds).
It takes the median of >= 9 individually-synced reps and re-measures
(keeping the min of medians — the right statistic under one-sided
contamination) until the selfcal/eop+tie per-observation ordering is
self-consistent or attempts run out: the eop+tie step does less work per
observation than the self-calibrating step on the same stream.

Outputs: {"t_selfcal_ms", "t_eop_tie_ms", "obs_selfcal", "obs_eop_tie",
"reps", "attempts", "suspect"}.
"""

import argparse
import json
import sys
import time


def median_step_ms(step, x0, obs, dtype, reps):
    import jax.numpy as jnp

    tol = jnp.asarray(1e-4, dtype)
    out = step(x0, obs, tol)  # warmup/compile
    float(out[1])
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = step(x0, obs, tol)
        float(out[1])
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=128)
    ap.add_argument("--n-pts", type=int, default=10_000)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--max-attempts", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from bench import _build, _make_step

    shape = (args.n_img, args.n_pts)
    prob_sc = _build(*shape, selfcal=True)
    step_sc, x_sc, obs_sc, _ = _make_step(prob_sc, np.float64)
    prob_et = _build(*shape, selfcal=False)
    step_et, x_et, obs_et, _ = _make_step(prob_et, np.float64)

    t_sc = float("inf")
    t_et = float("inf")
    attempts = 0
    while attempts < args.max_attempts:
        attempts += 1
        t_sc = min(t_sc, median_step_ms(step_sc, x_sc, obs_sc, np.float64,
                                        args.reps))
        t_et = min(t_et, median_step_ms(step_et, x_et, obs_et, np.float64,
                                        args.reps))
        # eop+tie strictly does less work per observation than selfcal on
        # the same stream: its per-obs time must not exceed selfcal's
        per_sc = t_sc / prob_sc.n_obs
        per_et = t_et / prob_et.n_obs
        consistent = per_et <= 1.10 * per_sc
        print(
            f"# attempt {attempts}: selfcal {t_sc:.1f} ms "
            f"({prob_sc.n_obs/t_sc*1e3:,.0f} obs/s)  eop+tie {t_et:.1f} ms "
            f"({prob_et.n_obs/t_et*1e3:,.0f} obs/s)"
            + ("" if consistent else "  [inconsistent, re-measuring]"),
            file=sys.stderr,
        )
        if consistent:
            break
    print(json.dumps({
        "t_selfcal_ms": round(t_sc, 2),
        "t_eop_tie_ms": round(t_et, 2),
        "obs_selfcal": int(prob_sc.n_obs),
        "obs_eop_tie": int(prob_et.n_obs),
        "reps": args.reps,
        "attempts": attempts,
        "suspect": bool(not consistent),
    }))


if __name__ == "__main__":
    main()
