"""Multi-chip execution: state-grid and action-axis sharding over a device mesh.

The reference is a single MATLAB process with no parallelism of any kind
(SURVEY.md §2.5); this package is the scaling layer mandated by the north
star: shard the DP backup over `jax.sharding.Mesh` axes with XLA
collectives between the devices.
"""

from .halo import value_iteration_converged_halo, value_iteration_finite_halo
from .halo6 import value_iteration_converged_halo6, value_iteration_finite_halo6
from .multihost import initialize_distributed, make_mesh
from .sharded import (
    ShardedPlan,
    shard_backup_inputs,
    sharded_bellman_sweeps,
    value_iteration_converged_sharded,
    value_iteration_finite_sharded,
)

__all__ = [
    "ShardedPlan",
    "shard_backup_inputs",
    "sharded_bellman_sweeps",
    "value_iteration_finite_sharded",
    "value_iteration_converged_sharded",
    "value_iteration_finite_halo",
    "value_iteration_finite_halo6",
    "value_iteration_converged_halo",
    "value_iteration_converged_halo6",
    "initialize_distributed",
    "make_mesh",
]
