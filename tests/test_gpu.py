"""Tests that need a GPU.  They skip without one; on a GPU host run

    FEBA_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu.solver.schur import (
    SchurOptions,
    solve_schur,
)
from fish_eye_bundle_adjustment_tpu.synth import make_block

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_f32_pinned_step_matches_f64_on_gpu(gpu_device):
    """The pinned-precision f32 solve on the GPU lands within 0.05 sigma
    of the f64 solve on the same GPU."""
    p = make_block(n_img=48, n_pts=3000, model="fisheye", seed=7,
                   settings_overrides=chip_smoke.SELFCAL,
                   control_frac=0.02).problem
    with jax.default_device(gpu_device):
        r64 = solve_schur(p)
        p32 = dataclasses.replace(p, settings=dataclasses.replace(
            p.settings, threshold=3e-4 * r64.layout.u, iteration_cap=40))
        r32 = solve_schur(
            p32, SchurOptions(dtype=np.float32, cg_maxiter=40, cg_tol=1e-6,
                              explicit_s=False),
            compute_covariance=False,
        )
    dx = chip_smoke.max_dx_over_sigma(r32.x, r64.x, r64.std, r64.layout)
    assert r32.converged and dx <= 0.05, dx


def test_smoke_parity_phase_on_gpu(gpu_device, tmp_path, monkeypatch):
    """The smoke's parity phase (CLI on the GPU vs the CPU device)."""
    monkeypatch.setattr(chip_smoke, "WORK", tmp_path)
    chip_smoke.phase_parity(chip_smoke.FULL_SIZES, "test")
