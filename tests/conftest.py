"""Test configuration: force CPU with a virtual 8-device mesh.

All tests run on the host CPU backend with 8 virtual devices, so the
multi-device sharding logic is exercised without hardware (the standard
JAX fake-mesh pattern).  Tests that need a GPU carry the ``gpu`` marker
and skip through the ``gpu_device`` fixture when none is visible; run
them on a GPU host with ``FEBA_TEST_GPU=1 python -m pytest tests/ -m gpu``
(which leaves the platform to JAX instead of forcing the CPU).

The cam0 reference dataset is optional; its tests skip without it, and
synthetic blocks (fish_eye_bundle_adjustment_tpu.synth) cover the same
paths.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

if os.environ.get("FEBA_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from pathlib import Path

REFERENCE = Path("/root/reference")


@pytest.fixture(scope="session")
def cam0_dir():
    if not REFERENCE.exists():
        pytest.skip("reference dataset not available")
    return REFERENCE


@pytest.fixture(scope="session")
def cam0_problem():
    """The bundled cam0 dataset, shipped config (pinhole self-calibration)."""
    if not REFERENCE.exists():
        pytest.skip("reference dataset not available")
    from fish_eye_bundle_adjustment_tpu.config import load_settings
    from fish_eye_bundle_adjustment_tpu.io.problem import load_problem

    settings = load_settings(REFERENCE / "config.cfg", default_output_stem="cam0")
    return load_problem(REFERENCE, settings=settings)


@pytest.fixture(scope="session")
def cam0_settings(cam0_problem):
    return cam0_problem.settings


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX sees none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with FEBA_TEST_GPU=1 on a GPU host)")
    return devs[0]
