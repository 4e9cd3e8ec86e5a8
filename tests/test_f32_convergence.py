"""f32 convergence evidence.

The bench runs GN steps in float32 on the device; that is only meaningful if
f32 iterations make genuine Gauss-Newton progress.  This test converges
the same solver in f32 and in f64 on a mid-size synthetic block and
requires the f32 solution to agree with the f64 one to well within the
parameters' own statistical uncertainty (0.1 sigma), i.e. the f32
rounding floor is far below the estimation noise floor.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions, solve_schur
from fish_eye_bundle_adjustment_tpu.synth import make_block
from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout


@pytest.mark.parametrize("selfcal", [False, True])
def test_f32_converges_to_f64_solution(selfcal):
    """eop+tie AND the flagship self-calibrating mode (r3 verdict item 3:
    the f32 convergence evidence must cover the selfcal unknowns —
    IOP/distortion columns — not just poses and ties)."""
    overrides = {"inner_constraints": False, "iteration_cap": 40}
    if selfcal:
        overrides.update(
            estimate_c=True, estimate_xp=True, estimate_yp=True,
            estimate_radial=True, estimate_decent=True,
        )
    blk = make_block(
        n_img=48, n_pts=3000, model="fisheye", seed=7,
        settings_overrides=overrides,
        control_frac=0.02,
    )
    problem = blk.problem
    layout = ParamLayout(problem)

    r64 = solve_schur(
        problem,
        SchurOptions(dtype=np.float64, cg_maxiter=200, obs_order="tie"),
        keep_history=False,
    )
    assert r64.converged and r64.std is not None

    # f32: the L1(delta) floor sits near 1.8e-4 per unknown — converge to
    # a threshold above it (the solver's adaptive forcing still drives the
    # solution to the f32 fixed point)
    import dataclasses

    problem_f32 = dataclasses.replace(
        problem,
        settings=dataclasses.replace(
            problem.settings, threshold=3e-4 * layout.u
        ),
    )
    r32 = solve_schur(
        problem_f32,
        SchurOptions(dtype=np.float32, cg_maxiter=200, obs_order="tie"),
        keep_history=False,
        compute_covariance=False,
    )
    assert r32.converged, (r32.iterations, r32.delta_history[-3:])

    # statistical agreement: |x32 - x64| << parameter std
    ratio = np.abs(r32.x - r64.x) / np.maximum(r64.std, 1e-12)
    assert ratio.max() < 0.1, ratio.max()
    # and the fit statistics match
    assert abs(r32.sigma02 - r64.sigma02) < 1e-3
    assert abs(r32.rms - r64.rms) < 1e-4
