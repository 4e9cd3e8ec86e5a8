"""Multi-host execution: 2-process jax.distributed CPU test
(parallel.mesh.init_distributed and the
make_array_from_process_local_data host-sharding path must actually run).

Two subprocesses each bring up jax.distributed over localhost with 2
virtual CPU devices, form the global 4-device mesh, shard their local
observation slices into global arrays, and run 3 SPMD GN steps.  The
per-step L1(delta) stream must match a single-process 4-device run of
the same problem to f64 roundoff.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_mp_worker.py"


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env():
    env = dict(os.environ)
    # pure-CPU multi-process: the worker sets its own platform and devices
    env.pop("JAX_PLATFORMS", None)
    pythonpath = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + pythonpath)
    env.pop("XLA_FLAGS", None)
    return env


def test_two_process_distributed_step():
    coordinator = f"localhost:{_free_port()}"
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coordinator, "2", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=str(REPO),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
    out0 = outs[0][1]
    assert "MP_OK" in out0, out0
    deltas = [float(l.split()[1]) for l in out0.splitlines() if l.startswith("DELTA")]
    assert len(deltas) == 3

    # single-process 4-device reference on the conftest fake mesh
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fish_eye_bundle_adjustment_tpu.parallel.dist_schur import (
        make_distributed_step,
    )
    from fish_eye_bundle_adjustment_tpu.parallel.mesh import make_mesh
    from fish_eye_bundle_adjustment_tpu.solver.schur import SchurOptions
    from fish_eye_bundle_adjustment_tpu.synth import make_block

    blk = make_block(
        n_img=8, n_pts=200, model="fisheye", seed=11,
        settings_overrides={"inner_constraints": False}, control_frac=0.05,
    )
    mesh = make_mesh(4)
    step, obs, layout, _ = make_distributed_step(
        blk.problem, mesh, SchurOptions(cg_maxiter=50, obs_order="tie")
    )
    x = jax.device_put(jnp.asarray(layout.initial()), NamedSharding(mesh, P()))
    tol = jnp.asarray(1e-8)
    ref = []
    for _ in range(3):
        x, deltasum, _, _, _ = step(x, obs, tol, jnp.asarray(0.0, x.dtype))
        ref.append(float(deltasum))
    # cross-process (Gloo) reductions reorder f64 sums vs the
    # single-process run; agreement is to reduction-order roundoff
    np.testing.assert_allclose(deltas, ref, rtol=1e-6)
