"""The fused Bellman backup: interpolate + stage-cost add + argmin sweep.

This is the hot op of the whole framework — the JAX equivalent of the
reference's

    J_F_next = F(X_next_M1, X_next_M2)
    [F.Values, u_star_idx] = min(J_F_next + J_current_state, [], 3)

(test/Dynamic_Solver.m:207-210; also attitude-control/Solver_attitude.m:400-409
and pos-att/Solver_pos_att.m:272). Semantics matched:

* tie-break = FIRST minimum along the action axis (MATLAB ``min``);
  ``jnp.argmin`` has the same first-occurrence rule.
* multi-axis action grids (attitude: chained ``min`` over dims 9,8,7) are
  flattened to one trailing action axis in (U1, U2, U3) C-order; a chained
  first-min over (U3, U2, U1) selects the lexicographically-smallest minimal
  (i1, i2, i3), which is exactly the first occurrence in C-order — so one flat
  argmin reproduces the reference's nested-index composition
  (Solver_attitude.m:290-292, prototyped in test_min_ndim.m:8-13).
* accumulation in float32 (the reference computes in MATLAB ``single``).

One DELIBERATE semantic divergence: MATLAB ``min`` IGNORES NaNs (a NaN
entry can never win), while ``jnp.min``/``jnp.argmin`` PROPAGATE them (any
NaN in a cell's action row poisons that cell). No reference workload
produces NaNs — costs are polynomials of finite grids and interpolation
weights are finite — so the two rules never disagree in practice; and
propagation is the better failure mode for a solver (a diverging value
table turns visibly NaN instead of being silently skipped over). If a
custom problem can produce NaN stage costs, mask them to +inf first
(``jnp.nan_to_num(cost, nan=jnp.inf)``) to recover the MATLAB rule.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .interp import InterpPlan, interp_apply

__all__ = ["BackupResult", "bellman_backup"]


class BackupResult(NamedTuple):
    values: jax.Array  # new value table, shape = state grid shape
    argmin: jax.Array  # int32 flat action index per state cell


def bellman_backup(values: jax.Array, plan: InterpPlan, stage_cost) -> BackupResult:
    """One backward value-iteration sweep.

    Args:
      values: current value table ``V_{k+1}``, shape ``plan.grid_shape``.
      plan: interpolation plan whose queries are the next states ``f(x, u)``
        for every state cell x action, shaped/broadcastable to
        ``(*state_shape, n_actions)`` (action axis LAST, flattened).
      stage_cost: ``g(x, u)`` broadcastable to the same query shape — either
        one array or a sequence of broadcast-shaped terms summed lazily
        (factorized costs never materialize the S x A tensor; XLA fuses the
        sum into the reduction).

    Returns:
      ``BackupResult(values=V_k, argmin=u*_index)`` with state-grid shape.
    """
    total = interp_apply(values, plan)
    if isinstance(stage_cost, (tuple, list)):
        for term in stage_cost:
            total = total + term
    else:
        total = total + stage_cost
    # Broadcast-resolve in case plan/cost are partially broadcast-shaped.
    full_shape = jnp.broadcast_shapes(total.shape, plan.query_shape)
    total = jnp.broadcast_to(total, full_shape)
    new_values = jnp.min(total, axis=-1)
    argmin = jnp.argmin(total, axis=-1).astype(jnp.int32)
    return BackupResult(new_values, argmin)
