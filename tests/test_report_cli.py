"""Report-writer and CLI/batch driver tests (reference L5)."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from fish_eye_bundle_adjustment_tpu.cli import batch, find_datasets, main
from fish_eye_bundle_adjustment_tpu.solver import stats as stats_mod

REFERENCE = Path("/root/reference")


@pytest.fixture(scope="module")
def cam0_dir(tmp_path_factory):
    if not REFERENCE.exists():
        pytest.skip("reference dataset not available")
    d = tmp_path_factory.mktemp("cam0")
    for f in REFERENCE.glob("cam0.*"):
        shutil.copy(f, d)
    shutil.copy(REFERENCE / "config.cfg", d)
    return d


class TestStats:
    def test_rsd_polar_decomposition(self, cam0_problem):
        """vr^2 + vt^2 == vx^2 + vy^2 (BuildRSD.m:30-36 identity)."""
        from fish_eye_bundle_adjustment_tpu.solver.dense import solve_dense

        res = solve_dense(cam0_problem, compute_covariance=False)
        rsd = stats_mod.build_rsd(cam0_problem, res.layout, res.x, res.v)
        np.testing.assert_allclose(
            rsd.vr**2 + rsd.vt**2, rsd.vx**2 + rsd.vy**2, rtol=1e-9
        )
        # radial distance measured from the estimated principal point
        off = res.layout.iop_offset
        xp, yp = res.x[off], res.x[off + 1]
        r0 = np.hypot(
            cam0_problem.obs_xy[0, 0] - xp, cam0_problem.obs_xy[0, 1] - yp
        )
        np.testing.assert_allclose(rsd.r[0], r0)

    def test_counts(self, cam0_problem):
        assert stats_mod.count_image_points(cam0_problem).sum() == 1029
        assert stats_mod.count_target_images(cam0_problem).max() >= 1


class TestCLI:
    def test_end_to_end(self, cam0_dir, tmp_path):
        out = tmp_path / "results"
        rc = main(cam0_dir, plot=True, out_dir=out)
        assert rc == 0
        stem = cam0_dir.name
        out_file = out / f"{stem}.out"
        assert out_file.exists()
        text = out_file.read_text()
        assert "Total Unknowns" in text and "580" in text
        assert "Total Degrees of Freedom" in text and "1485" in text
        # settings echo uses the reference's .cfg vocabulary
        # (main.m:647-652), not Python field names
        assert "Estimate_Xc" in text and "Meas_std" in text and "Type" in text
        assert "estimate_xc" not in text
        assert "A-Posteriori" in text
        assert "IOP Correlation sub-matrix" in text
        assert "Estimated Ground Coordinates" in text
        assert "Corrected Image Measurements" in text
        # .rsd: 1029 rows x 9 cols
        rsd_lines = (out / f"{stem}.rsd").read_text().strip().splitlines()
        assert len(rsd_lines) == 1029
        assert len(rsd_lines[0].split("\t")) == 9
        # .par contains every estimated IOP
        par = (out / f"{stem}.par").read_text()
        for name in ("xp", "yp", "c", "k1", "k5", "p1", "p2"):
            assert f"\n{name}\t" in par
        # 4 PNGs (main.m:510,536,563,582 naming)
        for prefix in ("delta_", "XcYcZc_", "wpk_", "RSDvR_"):
            assert (out / f"{prefix}{stem}.png").exists()

    def test_out_section_sequence_matches_reference(self, cam0_dir, tmp_path):
        """The .out sections appear with the reference's exact header
        strings IN THE REFERENCE'S ORDER (the fprintf literals of
        main.m:640-950) — the strongest format-parity check available
        without a MATLAB runtime."""
        out = tmp_path / "fmt"
        assert main(cam0_dir, plot=False, out_dir=out) == 0
        text = (out / f"{cam0_dir.name}.out").read_text()
        sections = [
            "Version: ",                                     # main.m:640
            "Execution date:",                               # main.m:646
            "Time Taken:",
            "Iterations:",
            "Model Used:",
            "Settings used:",                                # main.m:649
            "Observations/Unknowns Summary",                 # main.m:654
            "Estimated EOPs\nEOP Name\tValue\tStandard Deviation",  # :710
            "Estimated IOPs and Distortions for each Camera\n"
            "IOP Name\tValue\tStandard Deviation",           # main.m:772
            "IOP Correlation sub-matrix\n" + "-" * 31,       # main.m:827
            "Estimated Ground Coordinates of targets\n"
            "TargetID\tnumImages\tX\tY\tZ\tstdX\tstdY\tstdZ",  # main.m:868
            "MeanStd X\tMeanStd Y\tMeanStd Z",               # main.m:887
            "Corrected Image Measurements\n"
            "PointID\tImageID\tCorrected x\tCorrected y",    # main.m:892
            "Absolute (positive) mean correlation "
            "coefficients between EOPs and IOPs",            # main.m:902
        ]
        pos = -1
        for s in sections:
            nxt = text.find(s, pos + 1)
            assert nxt > pos, f"section missing or out of order: {s!r}"
            pos = nxt

    def test_missing_dataset_returns_error(self, tmp_path):
        assert main(tmp_path, plot=False) == 1

    @pytest.mark.parametrize("solver,extra", [
        ("distributed", {"devices": 4}),
        ("sharded", {"devices": 4}),
        ("posegraph", {"blocks": 2}),
    ])
    @pytest.mark.slow
    def test_scale_modes_end_to_end(self, tmp_path, solver, extra):
        """The flagship scale modes are reachable from the reference-style
        entry point and produce the same .out report set."""
        from fish_eye_bundle_adjustment_tpu.synth import make_block, write_block

        blk = make_block(n_img=12, n_pts=200, seed=31)
        data = tmp_path / "synth"
        write_block(blk, data)
        out = tmp_path / f"results_{solver}"
        rc = main(data, plot=False, out_dir=out, solver=solver, **extra)
        assert rc == 0
        outs = list(out.glob("*.out"))
        assert len(outs) == 1
        text = outs[0].read_text()
        assert "A-Posteriori" in text and "Estimated Ground Coordinates" in text

    def test_find_datasets(self, cam0_dir, tmp_path):
        root = tmp_path / "tree"
        (root / "a").mkdir(parents=True)
        (root / "b").mkdir()
        for f in cam0_dir.glob("cam0.*"):
            shutil.copy(f, root / "a")
        # b: partial set
        shutil.copy(cam0_dir / "cam0.pho", root / "b")
        found = find_datasets(root)
        assert found == [root / "a"]

    def test_batch(self, cam0_dir, tmp_path, capsys):
        root = tmp_path / "tree"
        (root / "a").mkdir(parents=True)
        for f in cam0_dir.glob("cam0.*"):
            shutil.copy(f, root / "a")
        # no .cfg in dataset folder -> fallback cfg (main.m:76-85)
        rc = batch(root, plot=False, cfg=cam0_dir / "config.cfg")
        assert rc == 0
        assert (root / "a" / "a.out").exists()
