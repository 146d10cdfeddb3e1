"""ocdp_tpu — accelerator-native optimal-control dynamic-programming framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``abdolrezat/Optimal-Control-Dynamic-Programming`` (backward Bellman value
iteration over discretized state x action grids for satellite position /
attitude / coupled position+attitude control, plus on-device closed-loop
rollouts against nonlinear orbital dynamics). See SURVEY.md for the feature
map and parity targets.
"""

from . import diagnostics, dynamics, engine, grids, io, models, parallel, utils
from .engine import (
    SolveResult,
    value_iteration_converged,
    value_iteration_finite,
)
from .grids import Grid, linspace_axis, sym_linspace_exact, sym_linspace_inclusive
from .ops.backup import BackupResult, bellman_backup
from .ops.interp import (
    InterpPlan,
    axis_locate,
    build_plan,
    interp_apply,
    interp_eval,
    nearest_eval,
)
from .ops.basegather import BaseGatherBackup, build_basegather_backup
from .ops.stencil import StencilBackup, build_stencil_backup
from .engine import value_iteration_segmented

__version__ = "0.2.0"

__all__ = [
    "Grid",
    "linspace_axis",
    "sym_linspace_exact",
    "sym_linspace_inclusive",
    "InterpPlan",
    "axis_locate",
    "build_plan",
    "interp_apply",
    "interp_eval",
    "BackupResult",
    "bellman_backup",
    "StencilBackup",
    "build_stencil_backup",
    "BaseGatherBackup",
    "build_basegather_backup",
    "SolveResult",
    "value_iteration_finite",
    "value_iteration_converged",
    "value_iteration_segmented",
]
