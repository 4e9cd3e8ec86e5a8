"""Stds-at-scale measurement.

Times the Hutchinson selected-diagonal estimator on blocks past any
feasible exact-covariance size and quantifies its error against the
exact dense-S block covariance on the largest block where the exact
path still runs.

Usage: python bench_stds.py [--accuracy-img 500] [--scale-img 5000]
       [--n-probe 16]
"""

import argparse
import json
import sys
import time

import numpy as np


def _solve(problem, dtype=np.float32):
    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        SchurOptions,
        solve_schur,
    )
    return solve_schur(
        problem, SchurOptions(dtype=dtype, cg_maxiter=40),
        keep_history=False, compute_covariance=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--accuracy-img", type=int, default=500)
    ap.add_argument("--accuracy-pts", type=int, default=20_000)
    ap.add_argument("--scale-img", type=int, default=5000)
    ap.add_argument("--scale-pts", type=int, default=400_000)
    ap.add_argument("--n-probe", type=int, default=16)
    args = ap.parse_args(argv)

    from fish_eye_bundle_adjustment_tpu.solver.covariance import (
        estimate_schur_stds,
        schur_covariance,
    )
    from fish_eye_bundle_adjustment_tpu.synth import make_block
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    out = {}

    # ---- accuracy vs exact on a mid-size block --------------------------
    blk = make_block(
        n_img=args.accuracy_img, n_pts=args.accuracy_pts, model="fisheye",
        seed=3, settings_overrides={"inner_constraints": False},
        control_frac=0.02,
    )
    p = blk.problem
    layout = ParamLayout(p)
    res = _solve(p)
    t0 = time.perf_counter()
    exact = schur_covariance(p, layout, res.x, res.sigma02).std
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = estimate_schur_stds(
        p, layout, res.x, res.sigma02, n_probe=args.n_probe, seed=1
    )
    t_est = time.perf_counter() - t0
    live = exact > 0
    rel = np.abs(est[live] - exact[live]) / exact[live]
    out["accuracy_block"] = {
        "n_img": p.n_img, "n_obs": p.n_obs, "u": layout.u,
        "exact_s": round(t_exact, 2),
        "hutchinson_s": round(t_est, 2),
        "n_probe": args.n_probe,
        "median_rel_err": round(float(np.median(rel)), 4),
        "q90_rel_err": round(float(np.quantile(rel, 0.9)), 4),
        "zero_clip_frac": round(
            float((live & (est == 0)).sum() / live.sum()), 5
        ),
    }
    print(f"# accuracy: {p.n_img} img u={layout.u}: exact {t_exact:.1f}s, "
          f"hutchinson({args.n_probe}) {t_est:.1f}s, "
          f"median rel {np.median(rel):.3f}", file=sys.stderr)

    # ---- wall time at scale (no exact possible) -------------------------
    # mild initialization: at 5k images the default synth perturbations
    # (pose 0.5 / point 1.0) can diverge undamped Gauss-Newton — this
    # harness times the std estimator, so start near the basin
    blk = make_block(
        n_img=args.scale_img, n_pts=args.scale_pts, model="fisheye",
        seed=4, settings_overrides={"inner_constraints": False},
        control_frac=0.01, init_pose_sigma=0.1, init_angle_sigma=5e-4,
        init_point_sigma=0.2,
    )
    p = blk.problem
    layout = ParamLayout(p)
    res = _solve(p)
    t0 = time.perf_counter()
    est = estimate_schur_stds(
        p, layout, res.x, res.sigma02, n_probe=args.n_probe, seed=1
    )
    t_scale = time.perf_counter() - t0
    assert np.all(np.isfinite(est))
    out["scale_block"] = {
        "n_img": p.n_img, "n_obs": p.n_obs, "u": layout.u,
        "n_probe": args.n_probe,
        "hutchinson_s": round(t_scale, 2),
        "s_per_probe": round(t_scale / args.n_probe, 3),
        "extrapolated_s_at_64_probes": round(t_scale / args.n_probe * 64, 1),
        "frac_positive": round(float((est > 0).mean()), 4),
    }
    print(f"# scale: {p.n_img} img u={layout.u} n_obs={p.n_obs}: "
          f"hutchinson({args.n_probe}) {t_scale:.1f}s "
          f"({t_scale/args.n_probe:.2f}s/probe)", file=sys.stderr)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
