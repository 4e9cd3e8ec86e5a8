"""Device mesh construction + multi-host initialization.

The reference is a single MATLAB process (SURVEY.md §2.5 — no parallelism
anywhere); everything here is new capability.

One logical axis suffices for bundle adjustment: ``obs`` — the observation
axis is embarrassingly parallel (per-observation residual/Jacobian work)
and all coupling flows through segment-sum reductions onto camera/point
state, which become ``psum`` collectives.  Across hosts the same axis
spans the network; `jax.distributed.initialize` wires the multi-host
runtime.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

OBS_AXIS = "obs"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the observation axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (OBS_AXIS,))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op when single-process).

    Pass the three arguments explicitly (coordinator as host:port)."""
    if num_processes is not None and num_processes > 1 or coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
