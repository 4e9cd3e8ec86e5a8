"""Fish-eye bundle adjustment framework.

A ground-up JAX/XLA re-design of the capabilities of
wynandtredoux/Fish-Eye_Bundle_Adjustment (a dense, serial MATLAB
photogrammetric bundle adjuster): five projection
models (equidistant fisheye, pinhole, equisolid, orthographic,
stereographic), self-calibration (principal point/distance + radial and
decentering lens distortion), inner-constraints free-network datum, and the
full `.pho/.ext/.cnt/.int/.tie/.cze/.cfg -> .out/.rsd/.par` I/O contract —
plus the distributed (Schur-complement, observation/point-sharded) solver
stack the reference lacks.

Numerical note: bundle adjustment normal equations are ill-conditioned
(condition numbers >1e12 with high-order radial terms), so the package
enables float64 globally; float32 runs are opt-in per solve
(SchurOptions.dtype).
"""

from jax import config as _jax_config

_jax_config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from fish_eye_bundle_adjustment_tpu.config import Settings  # noqa: E402,F401
from fish_eye_bundle_adjustment_tpu.io.problem import BAProblem, build_problem  # noqa: E402,F401
