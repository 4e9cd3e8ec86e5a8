from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh  # noqa: F401
from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import solve_schur_distributed  # noqa: F401
from fish_eye_bundle_adjustment_tpu.parallel.sharded_state import solve_schur_sharded_state  # noqa: F401
from fish_eye_bundle_adjustment_tpu.parallel.posegraph import solve_posegraph  # noqa: F401
