"""GPU smoke test of the adjuster's main path, through the entry points a
user calls.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the distributed modes only
    python chip_smoke.py --rehearse    # tiny sizes on any backend; never ok

Phases, in order; each raises on failure, and a failure exits non-zero
without the result line:

  device  JAX version and devices, the card's name and power limit
          (nvidia-smi, a subprocess off JAX); fails unless the platform
          is gpu.
  parity  a cam0-sized synthetic block (42 images, ~110 targets, pinhole
          self-calibration) through the CLI, where --solver auto picks
          solve_dense; the same solve on the CPU device in this process:
          sigma0^2 and rms to 1e-9 relative, |dx_j| <= 1e-6 sigma_j.
  schur   a 100-image f64 solve_schur with exact stds, GPU vs CPU:
          max |dx_j|/sigma_j <= 1e-3, sigma0^2 and stds to 1e-6 relative,
          the same iteration count.  Both runs converge to the same f64
          Gauss-Newton fixed point; only summation order and the CG stop
          at cg_tol 1e-10 differ.
  full    the BASELINE.json 1k-image / 100k-tie self-calibrating fisheye
          block (1% control), written as a dataset and run through the CLI
          (--solver schur --no-plots) in f64: stopped on threshold,
          sigma0^2 in [0.9, 1.1], exact stds, .out/.rsd/.par written.
          Prints per-stage wall times, compile time, peak device memory.
  f32     the f32 production configuration (cg_maxiter 40, device loop,
          iteration cap 60, stopping at the f32 plateau) on the same
          block, once at the precision the code pins and once
          under a TF32 default: sigma0^2 within 1% of f64 and
          max |dx|/sigma <= 0.1 for the pinned run.  Times the XLA
          S-matvec and its share of the HBM bandwidth bound.

--four-cards runs only the distributed phase: the 1k block on a 4-device
mesh through `distributed`, `sharded`, `sharded` with sharded points, and
`posegraph` (4 blocks, refined), each within max |dx|/sigma <= 1e-3 of
solve_schur on one card.

Last line: {"ok": true, "device": {"platform", "kind", "count"}}.
Working files go to .smoke/ beside this script (git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

SELFCAL = dict(
    estimate_c=True, estimate_xp=True, estimate_yp=True,
    estimate_radial=True, estimate_decent=True, inner_constraints=False,
)

# block sizes per phase: (n_img, n_pts); --rehearse shrinks them
FULL_SIZES = {"parity": (42, 110), "schur": (100, 5000),
              "full": (1000, 100_000)}
REHEARSE_SIZES = {"parity": (12, 60), "schur": (10, 300), "full": (16, 800)}


def log(msg: str) -> None:
    print(msg, flush=True)


def import_package():
    """Import the adjuster from this checkout, never from elsewhere."""
    sys.path.insert(0, str(ROOT))
    import fish_eye_bundle_adjustment_tpu as pkg

    where = Path(pkg.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f"package imported from {where}, not {ROOT}")
    return pkg


# ---------------------------------------------------------------- helpers

def make_dataset(out_dir, n_img, n_pts, model="fisheye", seed=2,
                 control_frac=0.01, **overrides):
    """Synthesize a self-calibrating block from `seed` and write it as a
    reference-format dataset; returns the SynthBlock."""
    from fish_eye_bundle_adjustment_tpu.synth import make_block, write_block

    blk = make_block(
        n_img=n_img, n_pts=n_pts, model=model, seed=seed,
        settings_overrides={**SELFCAL, **overrides},
        control_frac=control_frac,
    )
    write_block(blk, out_dir)
    return blk


def max_dx_over_sigma(x_a, x_b, std, layout=None) -> float:
    """max_j |x_a - x_b|_j / sigma_j over the unknowns with sigma_j > 0.
    With `layout`, EOP angle differences are taken modulo 2 pi (omega
    near pi and near -pi are one attitude)."""
    import numpy as np

    x_a, x_b, std = (np.asarray(a, np.float64) for a in (x_a, x_b, std))
    diff = x_a - x_b
    if layout is not None and layout.n_eop:
        is_angle = np.zeros(layout.u, bool)
        is_angle[: layout.eop_size] = np.tile(layout.eop_cols >= 3,
                                              layout.n_img)
        diff[is_angle] = (diff[is_angle] + np.pi) % (2 * np.pi) - np.pi
    live = std > 0
    if not live.any():
        raise ValueError("no positive stds to scale by")
    return float(np.max(np.abs(diff)[live] / std[live]))


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
_compile_s = [0.0]  # XLA backend compile seconds in this process


def _count_compiles() -> None:
    from jax import monitoring

    def on_event(name, secs, **_):
        if name == _COMPILE_EVENT:
            _compile_s[0] += secs

    monitoring.register_event_duration_secs_listener(on_event)


class StageRecorder:
    """Wraps module functions so a CLI run reports per-stage wall time and
    the XLA backend compile time spent inside each stage; the wrapped
    calls' arguments and results are kept for checks."""

    def __init__(self):
        self.stages = {}  # name -> dict(wall_s, compile_s, args, result)
        self._patches = []

    def wrap(self, module, attr, stage):
        orig = getattr(module, attr)

        def wrapped(*args, **kwargs):
            c0, t0 = _compile_s[0], time.perf_counter()
            result = orig(*args, **kwargs)
            self.stages[stage] = dict(
                wall_s=time.perf_counter() - t0,
                compile_s=_compile_s[0] - c0, args=args, result=result,
            )
            return result

        self._patches.append((module, attr, orig))
        setattr(module, attr, wrapped)

    def restore(self):
        for module, attr, orig in reversed(self._patches):
            setattr(module, attr, orig)
        self._patches.clear()


def run_cli(argv):
    """`cli.cli(argv)` in this process with the main path's stages
    recorded: problem build, solve (incl. stds), stds, report."""
    from fish_eye_bundle_adjustment_tpu import cli
    from fish_eye_bundle_adjustment_tpu.io import problem as problem_mod
    from fish_eye_bundle_adjustment_tpu.report import writers
    from fish_eye_bundle_adjustment_tpu.solver import covariance, dense, schur

    rec = StageRecorder()
    rec.wrap(problem_mod, "load_problem", "problem build")
    rec.wrap(dense, "solve_dense", "solve")
    rec.wrap(schur, "solve_schur", "solve")
    rec.wrap(covariance, "compute_stds", "stds")
    rec.wrap(writers, "write_reports", "report")
    try:
        rc = cli.cli([str(a) for a in argv])
    finally:
        rec.restore()
    return rc, rec


def report_files(out_dir):
    return {ext: sorted(Path(out_dir).glob(f"*.{ext}"))
            for ext in ("out", "rsd", "par")}


# ----------------------------------------------------------------- phases

def phase_device(require_gpu: bool):
    import jax

    from fish_eye_bundle_adjustment_tpu.utils.device import (
        device_info, gpu_name_and_power_limit,
    )

    info = device_info()
    log(f"jax {jax.__version__}; devices {jax.devices()}")
    log(f"device_kind {info['kind']}; platform {info['platform']}; "
        f"count {info['count']}")
    card = gpu_name_and_power_limit()
    log(f"nvidia-smi name, power.limit: {card}")
    if require_gpu and info["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {info['platform']}")
    return info, card


def phase_parity(sizes, label):
    """CLI (auto -> solve_dense) on the default device vs the CPU."""
    import jax

    from fish_eye_bundle_adjustment_tpu.io.problem import load_problem
    from fish_eye_bundle_adjustment_tpu.solver.dense import solve_dense

    n_img, n_pts = sizes["parity"]
    d, out = WORK / "parity", WORK / "parity_out"
    make_dataset(d, n_img, n_pts, model="pinhole", seed=7, control_frac=0.1)
    rc, rec = run_cli([d, "--no-plots", "--out-dir", out])
    check(rc == 0, f"parity CLI exited {rc}")
    check("solve" in rec.stages, "CLI did not reach a solver")
    r_dev = rec.stages["solve"]["result"]
    check(r_dev.std is not None, "dense solve returned no stds")
    check(all(report_files(out).values()), "parity reports missing")
    with jax.default_device(jax.devices("cpu")[0]):
        r_cpu = solve_dense(load_problem(d), keep_history=False)
    dx = max_dx_over_sigma(r_dev.x, r_cpu.x, r_dev.std, r_dev.layout)
    log(f"[{label}] parity ({n_img} img, dense, {r_dev.iterations} iters): "
        f"sigma0^2 {r_dev.sigma02!r} vs cpu {r_cpu.sigma02!r}; "
        f"rms {r_dev.rms!r} vs {r_cpu.rms!r}; max|dx|/sigma {dx:.3e}")
    check(rel(r_dev.sigma02, r_cpu.sigma02) <= 1e-9, "parity sigma0^2")
    check(rel(r_dev.rms, r_cpu.rms) <= 1e-9, "parity rms")
    check(dx <= 1e-6, f"parity |dx|/sigma {dx:.3e} > 1e-6")


def phase_schur(sizes, label):
    """f64 solve_schur with exact stds, default device vs the CPU."""
    import jax
    import numpy as np

    from fish_eye_bundle_adjustment_tpu.solver.schur import solve_schur
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    n_img, n_pts = sizes["schur"]
    p = make_block(n_img=n_img, n_pts=n_pts, model="fisheye", seed=5,
                   settings_overrides=SELFCAL, control_frac=0.02).problem
    t0 = time.perf_counter()
    r_dev = solve_schur(p)
    t_dev = time.perf_counter() - t0
    with jax.default_device(jax.devices("cpu")[0]):
        r_cpu = solve_schur(p)
    check(r_dev.std is not None and r_cpu.std is not None, "schur: no stds")
    dx = max_dx_over_sigma(r_dev.x, r_cpu.x, r_cpu.std, r_cpu.layout)
    live = r_cpu.std > 0
    std_rel = float(np.max(np.abs(r_dev.std - r_cpu.std)[live]
                           / r_cpu.std[live]))
    log(f"[{label}] schur parity ({n_img} img / {p.n_obs} obs, f64, "
        f"{t_dev:.2f} s on device incl. compile): iters {r_dev.iterations} "
        f"vs cpu {r_cpu.iterations}; sigma0^2 {r_dev.sigma02!r} vs "
        f"{r_cpu.sigma02!r}; max|dx|/sigma {dx:.3e}; max std rel diff "
        f"{std_rel:.3e}")
    check(r_dev.iterations == r_cpu.iterations, "schur iteration counts")
    check(rel(r_dev.sigma02, r_cpu.sigma02) <= 1e-6, "schur sigma0^2")
    check(dx <= 1e-3, f"schur |dx|/sigma {dx:.3e} > 1e-3")
    check(std_rel <= 1e-6, f"schur stds rel diff {std_rel:.3e} > 1e-6")


def phase_full(sizes, label):
    """The 1k block through the CLI, f64.  Returns (problem, result)."""
    import jax
    import numpy as np

    from fish_eye_bundle_adjustment_tpu.io import native

    n_img, n_pts = sizes["full"]
    d, out = WORK / "full", WORK / "full_out"
    t0 = time.perf_counter()
    make_dataset(d, n_img, n_pts, model="fisheye", seed=2)
    t_synth = time.perf_counter() - t0
    rc, rec = run_cli([d, "--solver", "schur", "--no-plots",
                       "--out-dir", out])
    check(rc == 0, f"full CLI exited {rc}")
    st = rec.stages
    problem = st["problem build"]["result"]
    res = st["solve"]["result"]
    solve_only = st["solve"]["wall_s"] - st["stds"]["wall_s"]
    compile_in_solve = st["solve"]["compile_s"] - st["stds"]["compile_s"]
    log(f"[{label}] full: {problem.n_img} img / {problem.n_tie} tie / "
        f"{problem.n_obs} obs / u={res.layout.u}; native parser "
        f"{'used' if native.available() else 'NOT available (numpy parser)'}")
    log(f"[{label}] full stages (s): synthesize+write {t_synth:.2f}; "
        f"problem build {st['problem build']['wall_s']:.2f}; "
        f"solve {solve_only:.2f} (XLA compile {compile_in_solve:.2f}); "
        f"stds {st['stds']['wall_s']:.2f} (XLA compile "
        f"{st['stds']['compile_s']:.2f}); report {st['report']['wall_s']:.2f}")
    log(f"[{label}] full: {res.iterations} iters, stopped_on "
        f"{res.stopped_on}, sigma0^2 {res.sigma02!r}, std method "
        f"{res.std_method}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{label}] full: peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    check(res.stopped_on == "threshold", f"stopped on {res.stopped_on}")
    check(0.9 <= res.sigma02 <= 1.1, f"sigma0^2 {res.sigma02} off [0.9, 1.1]")
    check(res.std is not None and res.std_method == "exact", "no exact stds")
    check(bool(np.all(np.isfinite(res.std))), "non-finite stds")
    files = report_files(out)
    check(all(files.values()), f"reports missing: {files}")
    return problem, res


def matvec_bytes(layout, n_obs: int) -> int:
    """Bytes one f32 S-matvec must read: the Jacobian streams (Je, Ji, Jp
    for x and y), the weights, and the img / tie / secondary-permutation
    index arrays, plus the per-tie Hpp^-1 table."""
    per_obs = 4 * (2 * layout.n_eop + 2 * layout.n_iop + 2 * 3 + 2) + 4 * 3
    return per_obs * n_obs + 4 * 9 * (layout.n_tie + 1)


def time_matvec(problem, x, label, reps=3, chain=50):
    """Seconds per XLA S-matvec (f32, chained in one jitted loop)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        ObsData, SchurKernel, SchurOptions, step_precision,
    )
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    layout = ParamLayout(problem)
    opts = SchurOptions(dtype=np.float32, obs_order="tie")
    kernel = SchurKernel(layout, opts, obs_order="tie")
    order = ObsData.sort_order_by_tie(problem, layout)
    obs = ObsData.from_problem(problem, layout, dtype=np.float32,
                               order=order, with_plan=True)
    q = jnp.asarray((np.asarray(x) * layout.scale).astype(np.float32))

    with step_precision():
        fac = jax.jit(kernel.linearize)(q, obs)

        @jax.jit
        def run(fac, v):
            def body(_, v):
                w = fac.schur_matvec(v)
                return w / jnp.sqrt(jnp.vdot(w, w))
            return jax.lax.fori_loop(0, chain, body, v)

        v = jnp.ones((kernel.nc,), jnp.float32)
        run(fac, v).block_until_ready()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(fac, v).block_until_ready()
            times.append((time.perf_counter() - t0) / chain)
    t = sorted(times)[len(times) // 2]
    nbytes = matvec_bytes(layout, problem.n_obs)
    bound = nbytes / HBM_BYTES_PER_S
    log(f"[{label}] XLA S-matvec (f32, {problem.n_obs} obs): "
        f"{t * 1e3:.4f} ms; reads >= {nbytes} B; HBM bound "
        f"{bound * 1e3:.4f} ms at 3.35 TB/s; share {bound / t:.4f}")
    return t, nbytes


def phase_f32(problem, res64, label):
    """f32 production configuration vs the f64 solution."""
    import jax

    import numpy as np

    from fish_eye_bundle_adjustment_tpu.solver.schur import (
        SchurOptions, solve_schur,
    )

    # the dataset's own threshold is below the f32 delta floor, so the
    # f32 solve stops on its plateau; a cap of 60 leaves room to reach it
    p32 = dataclasses.replace(problem, settings=dataclasses.replace(
        problem.settings, iteration_cap=60))
    opts = SchurOptions(dtype=np.float32, cg_maxiter=40, cg_tol=1e-6,
                        device_loop=True)
    runs = {}
    for name, ctx in (("pinned", contextlib.nullcontext()),
                      ("tf32 default",
                       jax.default_matmul_precision("tensorfloat32"))):
        with ctx:
            t0 = time.perf_counter()
            r = solve_schur(p32, opts, compute_covariance=False)
            wall = time.perf_counter() - t0
        dx = max_dx_over_sigma(r.x, res64.x, res64.std, res64.layout)
        log(f"[{label}] f32 {name}: {r.iterations} iters, stopped_on "
            f"{r.stopped_on}, sigma0^2 {r.sigma02!r} "
            f"(f64 {res64.sigma02!r}, rel {rel(r.sigma02, res64.sigma02):.3e}), "
            f"max|dx|/sigma {dx:.3e}, {wall:.2f} s incl. compile")
        runs[name] = (r, dx)
    r, dx = runs["pinned"]
    check(rel(r.sigma02, res64.sigma02) <= 0.01, "f32 sigma0^2 off by > 1%")
    check(dx <= 0.1, f"f32 max|dx|/sigma {dx:.3e} > 0.1")
    time_matvec(problem, res64.x, label)


def phase_four_cards(sizes, label):
    """The distributed modes on a 4-device mesh vs solve_schur on one."""
    import functools

    import jax

    from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import (
        make_distributed_step, solve_schur_distributed,
    )
    from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh
    from fish_eye_bundle_adjustment_tpu.parallel.posegraph import (
        solve_posegraph,
    )
    from fish_eye_bundle_adjustment_tpu.parallel.sharded_state import (
        solve_schur_sharded_state,
    )
    from fish_eye_bundle_adjustment_tpu.solver.schur import solve_schur
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    n_dev = len(jax.devices())
    check(n_dev == 4, f"--four-cards needs 4 devices, found {n_dev}")
    n_img, n_pts = sizes["full"]
    p = make_block(n_img=n_img, n_pts=n_pts, model="fisheye", seed=2,
                   settings_overrides=SELFCAL, control_frac=0.01).problem
    t0 = time.perf_counter()
    ref = solve_schur(p)
    log(f"[{label}] one card: {ref.iterations} iters, {ref.stopped_on}, "
        f"sigma0^2 {ref.sigma02!r}, {time.perf_counter() - t0:.2f} s "
        f"(incl. exact stds)")
    check(ref.std is not None, "one-card reference has no stds")
    mesh = make_mesh(4)
    _, obs, _, _ = make_distributed_step(p, mesh)
    shard_devs = [s.device for s in obs.img.addressable_shards]
    log(f"[{label}] obs shards on {shard_devs}")
    check(len(set(shard_devs)) == 4, "obs shards not on 4 distinct devices")
    modes = {
        "distributed": functools.partial(solve_schur_distributed, p, mesh),
        "sharded": functools.partial(solve_schur_sharded_state, p, mesh),
        "sharded points": functools.partial(
            solve_schur_sharded_state, p, mesh, point_mode="sharded"),
        "posegraph": lambda: solve_posegraph(p, n_blocks=4,
                                             refine=True).refined,
    }
    for name, solve in modes.items():
        t0 = time.perf_counter()
        r = solve()
        wall = time.perf_counter() - t0
        dx = max_dx_over_sigma(r.x, ref.x, ref.std, ref.layout)
        log(f"[{label}] {name}: {r.iterations} iters, {r.stopped_on}, "
            f"sigma0^2 {r.sigma02!r}, max|dx|/sigma {dx:.3e}, {wall:.2f} s")
        check(dx <= 1e-3, f"{name}: max|dx|/sigma {dx:.3e} > 1e-3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device distributed phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend; exits 3, never ok")
    args = ap.parse_args(argv)

    import_package()
    from fish_eye_bundle_adjustment_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from fish_eye_bundle_adjustment_tpu.utils.device import device_info

    enable_compile_cache()
    _count_compiles()
    info, card = phase_device(require_gpu=not args.rehearse)
    label = f"{info['kind']} | {card}"
    sizes = REHEARSE_SIZES if args.rehearse else FULL_SIZES
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(sizes, label)
    else:
        phase_parity(sizes, label)
        phase_schur(sizes, label)
        problem, res64 = phase_full(sizes, label)
        phase_f32(problem, res64, label)
    log(f"[{label}] all phases passed in {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    if args.rehearse:
        log("rehearsal only: no result line")
        return 3
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
