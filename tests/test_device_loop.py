"""Parity of the device-resident GN driver (solver/device_loop.py)
against the host reference loop (solver/schur.run_gn_loop): identical
iterates, identical accept/reject sequences, identical stopping reasons.
In f64 the two are the same arithmetic executed in different places, so
trajectories must agree to rounding."""

import dataclasses

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu.solver.schur import (
    SchurOptions,
    solve_schur,
)
from fish_eye_bundle_adjustment_tpu.synth import make_block
from fish_eye_bundle_adjustment_tpu.utils.observe import SolverDivergence


def _solve_both(problem, opts_kwargs=None, **kwargs):
    kw = dict(opts_kwargs or {})
    host = solve_schur(
        problem, SchurOptions(device_loop=False, **kw),
        compute_covariance=False, **kwargs,
    )
    dev = solve_schur(
        problem, SchurOptions(device_loop=True, device_chunk=4, **kw),
        compute_covariance=False, **kwargs,
    )
    return host, dev


@pytest.fixture(scope="module")
def block():
    return make_block(n_img=12, n_pts=240, model="fisheye", seed=13)


class TestParity:
    def test_converging_solve_matches(self, block):
        host, dev = _solve_both(block.problem)
        assert dev.converged and host.converged
        assert dev.iterations == host.iterations
        assert dev.stopped_on == host.stopped_on
        np.testing.assert_allclose(
            dev.delta_history, host.delta_history, rtol=1e-9
        )
        np.testing.assert_allclose(dev.x, host.x, rtol=0, atol=1e-10)
        np.testing.assert_allclose(
            dev.sigma02, host.sigma02, rtol=1e-10
        )
        # residual rows feed the report — must match too
        np.testing.assert_allclose(dev.v, host.v, rtol=0, atol=1e-9)

    def test_rejection_path_matches(self, block):
        """A grossly-perturbed start forces LM rejections; the lambda
        schedule and the accepted trajectory must match the host loop."""
        from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

        layout = ParamLayout(block.problem)
        rng = np.random.default_rng(5)
        x0 = layout.initial() + rng.normal(0, 1.0, layout.u) * np.abs(
            layout.initial() * 0.05 + 0.05
        )
        host_recs, dev_recs = [], []
        host = solve_schur(
            block.problem, SchurOptions(device_loop=False),
            compute_covariance=False, x0=x0,
            progress_fn=host_recs.append,
        )
        dev = solve_schur(
            block.problem, SchurOptions(device_loop=True, device_chunk=3),
            compute_covariance=False, x0=x0,
            progress_fn=dev_recs.append,
        )
        assert [r.accepted for r in dev_recs] == [
            r.accepted for r in host_recs
        ]
        np.testing.assert_allclose(
            [r.damping for r in dev_recs],
            [r.damping for r in host_recs], rtol=1e-9, atol=1e-300,
        )
        assert dev.iterations == host.iterations
        np.testing.assert_allclose(dev.x, host.x, rtol=0, atol=1e-8)

    def test_iteration_cap(self, block):
        limited = dataclasses.replace(
            block.problem.settings, iteration_cap=3
        )
        prob = dataclasses.replace(block.problem, settings=limited)
        host, dev = _solve_both(prob)
        assert not dev.converged and dev.iterations == 3
        assert dev.stopped_on == host.stopped_on == "cap"
        np.testing.assert_allclose(dev.x, host.x, rtol=0, atol=1e-10)

    def test_divergence_raises(self):
        """Non-adaptive mode + a start far outside the basin: the device
        loop must surface SolverDivergence exactly like check_divergence
        does on the host."""
        blk = make_block(n_img=8, n_pts=120, seed=3)
        from fish_eye_bundle_adjustment_tpu.utils.layout import ParamLayout

        layout = ParamLayout(blk.problem)
        rng = np.random.default_rng(11)
        x0 = layout.initial() * (
            1.0 + rng.normal(0, 0.5, layout.u)
        ) + rng.normal(0, 10.0, layout.u)
        opts = dict(adaptive_damping=False, plateau_detection=False)
        with pytest.raises(SolverDivergence):
            solve_schur(
                blk.problem,
                SchurOptions(device_loop=False, **opts),
                compute_covariance=False, x0=x0,
            )
        with pytest.raises(SolverDivergence):
            solve_schur(
                blk.problem,
                SchurOptions(device_loop=True, device_chunk=4, **opts),
                compute_covariance=False, x0=x0,
            )

    def test_progress_records(self, block):
        recs = []
        res = solve_schur(
            block.problem, SchurOptions(device_loop=True, device_chunk=5),
            compute_covariance=False, progress_fn=recs.append,
        )
        accepted = [r for r in recs if r.accepted]
        assert len(accepted) == res.iterations
        assert [r.iteration for r in accepted] == list(
            range(1, res.iterations + 1)
        )
        assert accepted[-1].delta_l1 == res.delta_history[-1]

    def test_checkpoint_resume(self, tmp_path, block):
        """Interrupt at the cap, resume from the chunk-boundary
        checkpoint, converge to the uninterrupted solution."""
        p = tmp_path / "ba.npz"
        full = solve_schur(
            block.problem, SchurOptions(device_loop=True),
            compute_covariance=False,
        )
        limited = dataclasses.replace(
            block.problem.settings, iteration_cap=2
        )
        prob2 = dataclasses.replace(block.problem, settings=limited)
        r2 = solve_schur(
            prob2, SchurOptions(device_loop=True, device_chunk=2),
            compute_covariance=False, checkpoint_path=p,
        )
        assert not r2.converged and r2.iterations == 2
        resumed = solve_schur(
            block.problem, SchurOptions(device_loop=True),
            compute_covariance=False, checkpoint_path=p,
        )
        assert resumed.converged
        assert resumed.iterations > 2
        np.testing.assert_allclose(resumed.x, full.x, atol=1e-8)


class TestF32:
    def test_f32_device_loop_matches_host_loop(self, monkeypatch):
        """f32 on the matrix-free XLA path (explicit S off, so the device
        loop really runs): same stop, same iterations within one, and the
        same solution to f32 noise."""
        import fish_eye_bundle_adjustment_tpu.solver.device_loop as dl

        calls = []
        real = dl.run_gn_loop_device
        monkeypatch.setattr(
            dl, "run_gn_loop_device",
            lambda *a, **k: calls.append(1) or real(*a, **k),
        )
        blk = make_block(n_img=6, n_pts=90, model="fisheye", seed=21)
        kw = dict(dtype=np.float32, obs_order="tie", explicit_s=False)
        host = solve_schur(
            blk.problem, SchurOptions(device_loop=False, **kw),
            compute_covariance=False,
        )
        dev = solve_schur(
            blk.problem, SchurOptions(device_loop=True, device_chunk=4,
                                      **kw),
            compute_covariance=False,
        )
        assert calls == [1], "device loop was not used"
        assert dev.stopped_on == host.stopped_on
        assert abs(dev.iterations - host.iterations) <= 1
        np.testing.assert_allclose(dev.x, host.x, rtol=0, atol=5e-4)
