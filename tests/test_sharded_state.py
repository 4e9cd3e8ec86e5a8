"""Sharded camera-state solver (parallel/sharded_state.py) equality with
the replicated distributed path and the single-device solver
(psum_scatter pose reductions + all_gather obs-side gather must
reproduce the replicated arithmetic)."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh
from fish_eye_bundle_adjustment_tpu.parallel.sharded_state import (
    solve_schur_sharded_state,
)
from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions, solve_schur
from fish_eye_bundle_adjustment_tpu.synth import make_block


def _block(ic: bool, n_img=10, seed=13):
    return make_block(
        n_img=n_img, n_pts=220, model="fisheye", seed=seed,
        settings_overrides={"inner_constraints": ic}, control_frac=0.05,
    ).problem


def test_sharded_state_matches_single_device():
    problem = _block(ic=False)
    opts = SchurOptions(cg_maxiter=100, obs_order="tie")
    r1 = solve_schur(problem, opts, keep_history=False,
                     compute_covariance=False)
    r8 = solve_schur_sharded_state(problem, make_mesh(8), opts,
                                   keep_history=False)
    assert r8.converged == r1.converged
    np.testing.assert_allclose(r8.x, r1.x, rtol=0, atol=1e-8)
    assert abs(r8.sigma02 - r1.sigma02) < 1e-10


def test_sharded_state_inner_constraints():
    """Free-network datum with per-device G row slices."""
    problem = _block(ic=True)
    opts = SchurOptions(cg_maxiter=150, obs_order="tie")
    r1 = solve_schur(problem, opts, keep_history=False,
                     compute_covariance=False)
    r8 = solve_schur_sharded_state(problem, make_mesh(8), opts,
                                   keep_history=False)
    np.testing.assert_allclose(r8.x, r1.x, rtol=0, atol=1e-7)


def test_sharded_state_nondivisible_images():
    """n_img not a multiple of the device count exercises the padded
    image slots (identity preconditioner blocks, zero CG rows)."""
    problem = _block(ic=False, n_img=11, seed=14)
    opts = SchurOptions(cg_maxiter=100, obs_order="tie")
    r1 = solve_schur(problem, opts, keep_history=False,
                     compute_covariance=False)
    r8 = solve_schur_sharded_state(problem, make_mesh(8), opts,
                                   keep_history=False)
    np.testing.assert_allclose(r8.x, r1.x, rtol=0, atol=1e-8)
