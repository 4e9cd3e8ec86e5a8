"""What the GPU bring-up relies on, checked on the CPU: the f32 XLA path
against f64, exact Schur stds against the dense oracle, the pinned
matmul precision, the compile-cache location, the entry shims'
failure modes, and the GPU smoke script's helpers at tiny sizes."""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu.solver.dense import solve_dense
from fish_eye_bundle_adjustment_tpu.solver.schur import (
    ObsData,
    SchurKernel,
    SchurOptions,
    make_pair_plan,
    schur_step_fn,
    solve_schur,
    step_precision,
)
from fish_eye_bundle_adjustment_tpu.synth import make_block
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

SELFCAL = chip_smoke.SELFCAL


def _selfcal_block(n_img=8, n_pts=240, seed=9):
    return make_block(n_img=n_img, n_pts=n_pts, model="fisheye", seed=seed,
                      settings_overrides=SELFCAL, control_frac=0.05).problem


@pytest.fixture(scope="module")
def selfcal_f64():
    p = _selfcal_block()
    return p, solve_schur(p)


# ---------------------------------------------------------------- f32 path

@pytest.mark.parametrize("explicit_s", [False, True])
def test_f32_schur_converges_to_f64(selfcal_f64, explicit_s):
    """f32 single-camera solve_schur (matrix-free or explicit S, XLA
    only) lands within 0.05 sigma of the f64 solution: the f32 rounding
    floor sits far below the estimation noise."""
    p, r64 = selfcal_f64
    # f32 stops at its delta floor, not at the f64 threshold
    p = dataclasses.replace(p, settings=dataclasses.replace(
        p.settings, threshold=3e-4 * r64.layout.u, iteration_cap=40))
    r32 = solve_schur(
        p, SchurOptions(dtype=np.float32, cg_maxiter=40, cg_tol=1e-6,
                        explicit_s=explicit_s),
        compute_covariance=False,
    )
    assert r32.converged
    dx = chip_smoke.max_dx_over_sigma(r32.x, r64.x, r64.std, r64.layout)
    assert dx <= 0.05, dx
    assert abs(r32.sigma02 / r64.sigma02 - 1.0) <= 1e-3


# ---------------------------------------------------- exact stds vs dense

@pytest.mark.parametrize("mode", ["selfcal", "inner_constraints",
                                  "eop_only"])
def test_exact_schur_stds_match_dense(mode):
    """The exact block covariance of the Schur path equals the dense
    oracle's stds (Cx = sigma0^2 N^-1, main.m:428-443)."""
    overrides = {"inner_constraints": False}
    control = 0.05
    if mode == "selfcal":
        overrides.update(SELFCAL)
    elif mode == "inner_constraints":
        overrides["inner_constraints"] = True
        control = 0.0
    else:
        overrides["estimate_tie"] = False
    p = make_block(n_img=6, n_pts=120, model="fisheye", seed=17,
                   settings_overrides=overrides,
                   control_frac=control).problem
    rd = solve_dense(p, keep_history=False)
    rs = solve_schur(p)
    assert rs.std_method == "exact"
    np.testing.assert_allclose(rs.std, rd.std, rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------ precision

def _dot_precisions(fn, *args):
    """precision params of every dot_general in fn's jaxpr (recursive)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


@pytest.mark.parametrize("explicit_s", [False, True])
def test_f32_step_dots_are_highest(explicit_s):
    """Every float32 contraction of the GN step runs at HIGHEST (a GPU
    may otherwise run f32 dots in TF32)."""
    p = _selfcal_block(n_img=6, n_pts=90)
    layout = ParamLayout(p)
    opts = SchurOptions(dtype=np.float32, cg_maxiter=4)
    kernel = SchurKernel(layout, opts, obs_order="tie")
    order = ObsData.sort_order_by_tie(p, layout)
    obs = ObsData.from_problem(p, layout, dtype=np.float32, order=order,
                               with_plan=True)
    pairs = (make_pair_plan(p, layout, SchurOptions(explicit_s=True), order)
             if explicit_s else None)
    step = schur_step_fn(kernel, layout, False, pairs=pairs)
    x = np.asarray(layout.initial(), np.float32)
    precs = _dot_precisions(
        lambda x, o, pr: step(x, o, np.float32(1e-4), np.float32(0.0), pr),
        x, obs, pairs,
    )
    assert precs, "no dot_general traced"
    highest = (jax.lax.Precision.HIGHEST,) * 2
    assert all(pr == highest for pr in precs), set(map(str, precs))


def test_explicit_matmul_precision_wins():
    """A caller's jax.default_matmul_precision overrides the pin."""
    assert jax.config.jax_default_matmul_precision is None
    with step_precision():
        assert jax.config.jax_default_matmul_precision == "highest"
    with jax.default_matmul_precision("tensorfloat32"):
        with step_precision():
            assert (jax.config.jax_default_matmul_precision
                    == "tensorfloat32")


def test_schur_options_have_no_kernel_knobs():
    names = {f.name for f in dataclasses.fields(SchurOptions)}
    assert not {n for n in names if n.startswith(("fused", "band_"))}


# ---------------------------------------------------------- compile cache

_CACHE_PROBE = (
    "from fish_eye_bundle_adjustment_tpu.utils.compile_cache import "
    "enable_compile_cache; import jax; d = enable_compile_cache(); "
    "print(d); print(jax.config.jax_compilation_cache_dir)"
)


def _probe_cache(cwd, env_dir=None):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         capture_output=True, text=True, check=True,
                         cwd=cwd)
    return out.stdout.split()


def test_compile_cache_env_var_honoured(tmp_path):
    helper_dir, jax_dir = _probe_cache(tmp_path, tmp_path / "cc")
    assert helper_dir == jax_dir == str(tmp_path / "cc")


def test_compile_cache_fixed_path_without_env(tmp_path):
    first, second = _probe_cache(tmp_path), _probe_cache(tmp_path)
    assert first == second
    assert first[0] == first[1] == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


# ------------------------------------------------------------ entry shims

def test_dryrun_multichip_raises_without_devices():
    import __graft_entry__ as graft

    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft.dryrun_multichip(16)


def test_cli_without_matplotlib_exits_1(tmp_path, monkeypatch, capsys):
    from fish_eye_bundle_adjustment_tpu import cli

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc = cli.main(tmp_path, plot=True)
    assert rc == 1
    assert "--no-plots" in capsys.readouterr().err


def test_plots_module_imports_without_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules,
                        "fish_eye_bundle_adjustment_tpu.report.plots",
                        raising=False)
    import fish_eye_bundle_adjustment_tpu.report.plots as plots

    assert callable(plots.write_plots)


def test_cli_has_no_fused_sharded_solver():
    from fish_eye_bundle_adjustment_tpu import cli

    with pytest.raises(SystemExit):
        cli._build_parser().parse_args(["x", "--solver", "fused_sharded"])


# ------------------------------------------------------------- chip smoke

def _run_smoke(cwd, script, *args, env_extra=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_rehearsal_runs_every_phase(tmp_path):
    """--rehearse: every single-device phase at tiny sizes on the CPU;
    exits 3 and never prints the result line."""
    out = _run_smoke(REPO, REPO / "chip_smoke.py", "--rehearse",
                     env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 3, out.stderr[-2000:]
    assert "all phases passed" in out.stdout
    assert "XLA S-matvec" in out.stdout
    assert '"ok": true' not in out.stdout


def test_smoke_dataset_cli_round_trip(tmp_path, monkeypatch):
    """synthesize + write + CLI (auto -> dense) with the stage recorder."""
    # keeps cli.cli() from pointing this process's compile cache anywhere
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    d, out = tmp_path / "ds", tmp_path / "out"
    chip_smoke.make_dataset(d, 8, 60, model="pinhole", seed=7,
                            control_frac=0.1)
    rc, rec = chip_smoke.run_cli([d, "--no-plots", "--out-dir", out])
    assert rc == 0
    assert {"problem build", "solve", "report"} <= set(rec.stages)
    res = rec.stages["solve"]["result"]
    assert res.converged and res.std is not None
    assert all(chip_smoke.report_files(out).values())
    # the recorder put every wrapped function back
    from fish_eye_bundle_adjustment_tpu.solver import dense

    assert dense.solve_dense is solve_dense


def test_smoke_dx_over_sigma_flags_perturbation():
    layout = ParamLayout(_selfcal_block(n_img=4, n_pts=40))
    rng = np.random.default_rng(0)
    x = rng.normal(size=layout.u)
    std = np.full(layout.u, 0.5)
    assert chip_smoke.max_dx_over_sigma(x, x.copy(), std, layout) == 0.0
    y = x.copy()
    y[layout.tie_offset] += 0.05  # 0.1 sigma on one tie coordinate
    assert np.isclose(chip_smoke.max_dx_over_sigma(y, x, std, layout), 0.1)
    # an attitude angle that wrapped by 2 pi is the same attitude
    ang = int(np.nonzero(layout.eop_cols >= 3)[0][0])
    z = x.copy()
    z[ang] += 2 * np.pi
    assert chip_smoke.max_dx_over_sigma(z, x, std, layout) < 1e-9
    assert chip_smoke.max_dx_over_sigma(z, x, std) > 10


def test_smoke_matvec_bytes_counts_streams():
    layout = ParamLayout(_selfcal_block(n_img=4, n_pts=40))
    n = 1000
    per_obs = 4 * (2 * layout.n_eop + 2 * layout.n_iop + 8) + 12
    assert chip_smoke.matvec_bytes(layout, n) == (
        per_obs * n + 36 * (layout.n_tie + 1))
