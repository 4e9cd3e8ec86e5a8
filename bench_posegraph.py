"""Pose-graph end-to-end wall time.

Runs the full partition -> parallel block solves -> similarity merge ->
global refine pipeline on the single-device bench block and records the
end-to-end wall time plus merge quality (the block solves dispatch
concurrently, parallel/posegraph.py).

Usage: python bench_posegraph.py [--n-img 1000] [--n-pts 100000]
       [--blocks 4]
"""

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-img", type=int, default=1000)
    ap.add_argument("--n-pts", type=int, default=100_000)
    ap.add_argument("--blocks", type=int, default=4)
    args = ap.parse_args(argv)

    from fish_eye_bundle_adjustment_tpu.parallel.posegraph import (
        solve_posegraph,
    )
    from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    blk = make_block(
        n_img=args.n_img, n_pts=args.n_pts, model="fisheye", seed=2,
        settings_overrides={"inner_constraints": False}, control_frac=0.01,
    )
    problem = blk.problem
    opts = SchurOptions(dtype=np.float32, cg_maxiter=40)

    t0 = time.perf_counter()
    pg = solve_posegraph(
        problem, n_blocks=args.blocks, options=opts, refine=True,
        parallel_blocks=True, compute_covariance=False,
    )
    t_total = time.perf_counter() - t0
    ref = pg.refined
    out = {
        "n_img": problem.n_img, "n_obs": problem.n_obs,
        "n_blocks": args.blocks, "n_edges": len(pg.edges),
        "end_to_end_s": round(t_total, 2),
        "block_solve_s": [round(r.elapsed_s, 2) for r in pg.block_results],
        "refine_iterations": ref.iterations if ref else None,
        "refine_sigma02": round(ref.sigma02, 5) if ref else None,
    }
    print(f"# posegraph {args.blocks} blocks on {problem.n_img} img / "
          f"{problem.n_obs} obs: {t_total:.1f}s end-to-end, refine "
          f"{out['refine_iterations']} iters sigma02={out['refine_sigma02']}",
          file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
