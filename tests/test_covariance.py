"""Schur-path covariance (solver/covariance.py) vs the dense reference.

The reference reports +-sigma for every unknown from Cx = sigma0^2 N^-1
(main.m:428-443, 712-897); the dense solver reproduces that exactly, so
it is the oracle here: the Schur path must match the dense stds (held
to 1e-8 relative on cam0).
"""

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu.solver.dense import solve_dense
from fish_eye_bundle_adjustment_tpu.solver.schur import solve_schur
from fish_eye_bundle_adjustment_tpu.synth import make_block


def _compare(problem, rel_tol=1e-8):
    rd = solve_dense(problem)
    rs = solve_schur(problem)
    assert rs.std is not None
    assert np.all(np.isfinite(rs.std))
    rel = np.abs(rd.std - rs.std) / np.maximum(np.abs(rd.std), 1e-30)
    assert rel.max() < rel_tol, rel.max()
    cd, cs = rd.camera_correlation(), rs.camera_correlation()
    assert np.abs(cd - cs).max() < 1e-7
    return rd, rs


@pytest.mark.slow
def test_cam0_schur_stds_match_dense(cam0_problem):
    """Shipped cam0 config: pinhole, self-calibration, inner constraints."""
    _compare(cam0_problem)


@pytest.mark.slow
def test_synth_no_constraints_stds():
    blk = make_block(
        n_img=8, n_pts=150, model="fisheye", seed=3,
        settings_overrides={"inner_constraints": False},
        control_frac=0.05,
    )
    _compare(blk.problem)


@pytest.mark.slow
def test_synth_multicam_stds():
    """Two-camera rig exercises the per-camera IOP cross blocks."""
    blk = make_block(
        n_img=10, n_pts=200, n_cams=2, model="fisheye", seed=4,
        settings_overrides={"inner_constraints": False},
        control_frac=0.05,
    )
    _compare(blk.problem)


def test_gate_returns_none_std():
    """Past the max_images gate the solver leaves std=None (report
    prints n/a instead of fabricated numbers)."""
    from fish_eye_bundle_adjustment_tpu.solver.covariance import schur_covariance
    from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

    blk = make_block(n_img=6, n_pts=80, seed=0,
                     settings_overrides={"inner_constraints": False})
    layout = ParamLayout(blk.problem)
    cov = schur_covariance(
        blk.problem, layout, layout.initial(), 1.0, max_images=4
    )
    assert cov is None
