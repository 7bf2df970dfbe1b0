"""Device mesh construction + multi-host initialization helpers.

The reference is single-process (SURVEY §5.8); this module is the entry
point for scaling the mapping backend across chips and hosts:

- ``initialize_distributed``: ``jax.distributed.initialize`` glue for
  multi-host runs (no-op when single-host)
- ``make_map_mesh``: 1-D mesh over all devices for the
  measurement-parallel global BA (``parallel.sharded_ba``)
- ``make_hybrid_mesh``: 2-D (process, local-device) mesh for runs that
  span several hosts; one process on one host (for example four GPUs
  joined all to all by NVLink) uses the 1-D ``make_map_mesh``
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialize multi-host JAX if requested via args or env
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns True if distributed mode is active."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_map_mesh(n_devices: Optional[int] = None,
                  axis: str = "mp") -> Mesh:
    """1-D mesh over (up to) all devices — the map-parallel axis for the
    sharded global BA."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_hybrid_mesh(axes: Tuple[str, str] = ("host", "chip")) -> Mesh:
    """2-D (process, local-device) mesh: shard the measurement axis over
    each host's devices and the outer axis over hosts, so the Schur psum
    reduces within a host before it crosses the network between hosts.
    Every device of one host reaches every other at the same rate, so a
    single-host run needs only the 1-D ``make_map_mesh``."""
    devs = jax.devices()
    n_proc = jax.process_count()
    local = len(devs) // max(n_proc, 1)
    grid = np.array(devs).reshape(n_proc, local)
    return Mesh(grid, axes)


def pad_to_multiple(n: int, devices: int) -> int:
    """Measurement-capacity helper: round up so the shard divides."""
    return ((n + devices - 1) // devices) * devices
