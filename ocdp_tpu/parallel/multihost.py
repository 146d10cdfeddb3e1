"""Multi-host (DCN) initialization and mesh construction.

The reference is a single MATLAB process (SURVEY.md §2.5: no NCCL/MPI/Gloo
anywhere); the comms story here is ``jax.distributed`` for process
bootstrap plus XLA collectives within a host (NVLink between a host's GPUs)
and across hosts.
This module is the thin bootstrap layer: both sharded engines
(``parallel.sharded``, ``parallel.halo``) are mesh-agnostic — hand them a
multi-host mesh from :func:`make_mesh` and their ``all_gather`` /
``ppermute`` collectives ride whatever fabric connects the devices.

Layout guidance: put the STATE axis of the mesh within a host so per-sweep
halo/gather traffic stays on the host's device links; use a host-level
axis only for coarse work splitting (e.g. one pos-att channel per host —
the embarrassingly-parallel "expert" axis).

Single-host with N local devices needs no initialization — ``make_mesh``
alone suffices (and is how the test suite runs, on 8 virtual CPU devices).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_distributed", "make_mesh"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap multi-process JAX (one process per host).

    Pass the coordinator address, process count and process id explicitly
    (nothing here detects a cluster from the environment). Safe to call
    once per process, before any computation. No-op for a single process.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    axis_names: Sequence[str] = ("s",),
    axis_sizes: Optional[Sequence[int]] = None,
    *,
    devices=None,
) -> Mesh:
    """Build a Mesh over all (global) devices.

    ``axis_sizes`` defaults to putting every device on the first axis. Axis
    order follows JAX device order: earlier axes change slowest, so placing
    the state axis LAST keeps neighboring state blocks on consecutive
    devices for the halo engine.
    """
    devs = np.array(devices if devices is not None else jax.devices())
    n = devs.size
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} != {n} devices")
    return Mesh(devs.reshape(tuple(axis_sizes)), tuple(axis_names))
