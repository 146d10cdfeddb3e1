"""Sharded Bellman backups: state-grid + action-axis sharding via ``shard_map``.

Design (see SURVEY.md §2.5/§5):

* **State-grid sharding** (the DP analog of data parallelism): the query
  tensors ``f(x,u)`` and the stage cost are sharded in blocks along one state
  axis of the ``(*state_shape, n_actions)`` query layout. The value table
  ``V`` — which every shard must read, because dynamics can carry a next
  state anywhere in the grid — is kept **replicated**; each sweep every
  device computes the backup for its own state block and the new table is
  reassembled with one ``all_gather``. Per sweep this moves
  O(|grid|) bytes while computing O(|grid| x |actions|) FLOPs, so the
  collective is negligible next to the backup itself (the reference's grids
  have 3–1000 actions per state).

* **Action-axis sharding** (the tensor-parallel analog, for huge action sets
  like Dynamic_Solver's 1000-control axis): each device reduces min/argmin
  over its local action block, then the cross-device combine takes the
  global first-minimum via an ``all_gather`` over the action mesh axis —
  device order equals ascending action offset, so MATLAB ``min`` first-min
  tie-breaking (test/Dynamic_Solver.m:209) is preserved exactly.

Axis sizes that don't divide the mesh are padded: state-axis padding repeats
the edge block (computed rows are sliced off after the gather), action-axis
padding gets ``+inf`` stage cost so padded actions never win the argmin.

The whole sweep loop (``lax.scan``) runs *inside* one ``shard_map``, so a
multi-sweep solve is a single XLA computation with one collective per sweep.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import SolveResult, convergence_stop, policy_dtype_for
from ..ops.interp import InterpPlan, interp_apply

__all__ = [
    "ShardedPlan",
    "shard_backup_inputs",
    "sharded_bellman_sweeps",
    "value_iteration_finite_sharded",
    "value_iteration_converged_sharded",
]


def _pad_axis(arr: jax.Array, axis: int, target: int, mode: str) -> jax.Array:
    """Pad ``arr`` along ``axis`` up to ``target`` (edge-repeat or +inf)."""
    n = arr.shape[axis]
    if n == target:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    if mode == "edge":
        return jnp.pad(arr, pad, mode="edge")
    return jnp.pad(arr, pad, constant_values=jnp.inf)


class ShardedPlan:
    """Padded plan/cost plus the PartitionSpecs that block them over the mesh."""

    def __init__(self, plan, cost, in_specs, state_size, action_size, shard_axis,
                 state_axis_name, action_axis_name):
        self.plan = plan
        self.cost = cost
        self.in_specs = in_specs
        self.state_size = state_size          # unpadded size of the sharded state axis
        self.action_size = action_size        # unpadded number of actions
        self.shard_axis = shard_axis
        self.state_axis_name = state_axis_name
        self.action_axis_name = action_axis_name


def shard_backup_inputs(
    plan: InterpPlan,
    stage_cost: jax.Array,
    mesh: Mesh,
    *,
    shard_axis: int = 0,
    state_axis_name: str = "s",
    action_axis_name: Optional[str] = None,
) -> ShardedPlan:
    """Pad + spec the backup inputs for ``shard_map`` over ``mesh``.

    ``shard_axis`` picks which *state* axis of the query layout is blocked
    across ``state_axis_name``; the trailing action axis is optionally blocked
    across ``action_axis_name``. Broadcast-shaped (singleton) plan arrays stay
    replicated along axes where they don't vary.
    """
    q_shape = plan.query_shape
    ndim = len(q_shape)
    action_axis = ndim - 1
    if shard_axis >= action_axis:
        raise ValueError("shard_axis must be a state axis (not the action axis)")

    n_state_shards = mesh.shape[state_axis_name]
    n_action_shards = mesh.shape[action_axis_name] if action_axis_name else 1
    s_pad = -(-q_shape[shard_axis] // n_state_shards) * n_state_shards
    a_pad = -(-q_shape[action_axis] // n_action_shards) * n_action_shards

    def prep(arr, cost_axis_pad=False):
        arr = jnp.asarray(arr)
        spec = [None] * ndim
        if arr.shape[shard_axis] > 1:
            arr = _pad_axis(arr, shard_axis, s_pad, "edge")
            spec[shard_axis] = state_axis_name
        if action_axis_name and arr.shape[action_axis] > 1:
            arr = _pad_axis(arr, action_axis, a_pad,
                            "inf" if cost_axis_pad else "edge")
            spec[action_axis] = action_axis_name
        return arr, P(*spec)

    # NOTE: spec order must match the engines' flat argument order
    # (all lo, then all frac, then cost) — interleaving lo/frac specs here
    # mis-shards broadcast-shaped plans whose per-axis arrays differ.
    lo, frac, lo_specs, fr_specs = [], [], [], []
    for l, f in zip(plan.lo, plan.frac):
        l2, sl = prep(l)
        f2, sf = prep(f)
        lo.append(l2)
        frac.append(f2)
        lo_specs.append(sl)
        fr_specs.append(sf)
    specs = lo_specs + fr_specs

    # The argmin must never pick a padded action: pad the cost with +inf. If
    # the cost is broadcast along the action axis but padding is needed there,
    # materialize that axis first so +inf can be written.
    cost = jnp.asarray(stage_cost)
    if action_axis_name and a_pad != q_shape[action_axis] and cost.shape[action_axis] == 1:
        cost = jnp.broadcast_to(
            cost, cost.shape[:action_axis] + (q_shape[action_axis],) + cost.shape[ndim:]
        )
    cost, sc = prep(cost, cost_axis_pad=True)
    if action_axis_name and sc[action_axis] is None and a_pad != q_shape[action_axis]:
        raise AssertionError("padded action axis requires sharded cost")
    specs.append(sc)

    padded = InterpPlan(tuple(lo), tuple(frac), plan.grid_shape)
    return ShardedPlan(padded, cost, tuple(specs), q_shape[shard_axis],
                       q_shape[action_axis], shard_axis, state_axis_name,
                       action_axis_name)


def _local_backup(v, plan, cost, sp: ShardedPlan):
    """One device's backup over its (state-block x action-block) queries.

    Returns the block's new values and *global* flat-action argmin, combining
    across the action mesh axis with first-min tie-breaking when the action
    axis is sharded.
    """
    total = interp_apply(v, plan) + cost
    full = jnp.broadcast_shapes(total.shape, plan.query_shape)
    total = jnp.broadcast_to(total, full)
    vals = jnp.min(total, axis=-1)
    args = jnp.argmin(total, axis=-1).astype(jnp.int32)
    if sp.action_axis_name is None:
        return vals, args
    a_block = total.shape[-1]
    offset = jax.lax.axis_index(sp.action_axis_name) * a_block
    args = args + offset
    # device order along the gather dim == ascending action offset, so argmin
    # over that dim keeps MATLAB first-min semantics across shards.
    vals_g = jax.lax.all_gather(vals, sp.action_axis_name)
    args_g = jax.lax.all_gather(args, sp.action_axis_name)
    best = jnp.argmin(vals_g, axis=0)
    vals = jnp.take_along_axis(vals_g, best[None], axis=0)[0]
    args = jnp.take_along_axis(args_g, best[None], axis=0)[0]
    return vals, args


def sharded_bellman_sweeps(
    sp: ShardedPlan,
    mesh: Mesh,
    num_sweeps: int,
    *,
    init_values: Optional[jax.Array] = None,
    store_policies: bool = False,
):
    """Run ``num_sweeps`` backups under ``shard_map``; see module docstring.

    Returns ``(values, argmin, policies)`` as *global* (unpadded) arrays:
    the final value table, the last sweep's argmin, and — when requested —
    the per-sweep policy stack ``(num_sweeps, *state_shape)``.
    """
    grid_shape = sp.plan.grid_shape
    if init_values is None:
        init_values = jnp.zeros(grid_shape, jnp.float32)
    sa, name = sp.shard_axis, sp.state_axis_name
    n_s = mesh.shape[name]
    pad_rows = sp.plan.query_shape[sa] - sp.state_size

    n_state_dims = len(sp.plan.query_shape) - 1
    pol_spec = P(*([None] + [name if i == sa else None
                             for i in range(n_state_dims)]))

    def run(v0, *flat):
        k = len(sp.plan.lo)
        plan = InterpPlan(tuple(flat[:k]), tuple(flat[k:2 * k]), grid_shape)
        cost = flat[2 * k]

        pdt = policy_dtype_for(sp.action_size)

        def sweep(carry, _):
            v, _ = carry
            vals, args = _local_backup(v, plan, cost, sp)
            v_new = jax.lax.all_gather(vals, name, axis=sa, tiled=True)
            if pad_rows:
                v_new = jax.lax.slice_in_dim(v_new, 0, sp.state_size, axis=sa)
            return (v_new, args), (args.astype(pdt) if store_policies
                                   else None)

        block_state = tuple(
            (s // n_s if i == sa else s)
            for i, s in enumerate(sp.plan.query_shape[:-1])
        )
        init = (v0, jnp.zeros(block_state, jnp.int32))
        (v_fin, args), pols = jax.lax.scan(sweep, init, None, length=num_sweeps)
        args_full = jax.lax.all_gather(args, name, axis=sa, tiled=True)
        if pad_rows:
            args_full = jax.lax.slice_in_dim(args_full, 0, sp.state_size, axis=sa)
        if store_policies:
            # pols stay block-local; out_specs reassembles them (padding, if
            # any, lands at the end of the axis and is sliced off outside).
            return v_fin, args_full, pols
        return v_fin, args_full

    in_specs = (P(),) + sp.in_specs
    out_specs = (P(), P(), pol_spec) if store_policies else (P(), P())
    fn = jax.shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_vma=False)
    flat = tuple(sp.plan.lo) + tuple(sp.plan.frac) + (sp.cost,)
    out = fn(init_values, *flat)
    if store_policies:
        v_fin, args_full, pols = out
        if pad_rows:
            pols = jax.lax.slice_in_dim(pols, 0, sp.state_size, axis=sa + 1)
        return v_fin, args_full, pols
    return out[0], out[1], None


def _record_check(do_check, k_s, err_f, err_u, checks, c_idx,
                  on_check, axis_name):
    """Append a ``[k_s, errorF, errorU]`` row when ``do_check``; when
    ``on_check`` is given, stream it to the host exactly once per check
    (the emit is gated to mesh coordinate 0 along ``axis_name``)."""
    def record(args):
        checks, c_idx = args
        if on_check is not None:
            jax.lax.cond(
                jax.lax.axis_index(axis_name) == 0,
                lambda: jax.debug.callback(on_check, k_s, err_f, err_u),
                lambda: None)
        row = jnp.stack([k_s.astype(jnp.float32), err_f, err_u])
        return checks.at[c_idx].set(row), c_idx + 1

    return jax.lax.cond(do_check, record, lambda a: a, (checks, c_idx))


def value_iteration_converged_sharded(
    plan: InterpPlan,
    stage_cost: jax.Array,
    max_sweeps: int,
    mesh: Mesh,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    shard_axis: int = 0,
    state_axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[jax.Array] = None,
    on_check=None,
) -> SolveResult:
    """Mesh-sharded twin of :func:`ocdp_tpu.engine.value_iteration_converged`.

    The early-stop decision (pos-att/Solver_pos_att.m:268-286) must be
    IDENTICAL on every device or the mesh deadlocks. After each sweep's
    ``all_gather`` every device holds the full (unpadded) table, so
    ``errorF = Δ Σ V`` is computed redundantly-but-identically per device;
    ``errorU = Δ Σ argmin`` sums each device's local block and combines with
    a ``psum`` over the state mesh axis (padded rows masked out). Results
    match the single-chip engine bitwise, including the stopping sweep.

    ``on_check(k_s, errorF, errorU)`` streams each check to the host (the
    reference's per-check print, Solver_pos_att.m:278) exactly once — the
    emit is gated to mesh coordinate 0, whose owning process runs the
    callback.
    """
    sp = shard_backup_inputs(
        plan, stage_cost, mesh, shard_axis=shard_axis,
        state_axis_name=state_axis_name, action_axis_name=action_axis_name,
    )
    grid_shape = sp.plan.grid_shape
    if init_values is None:
        init_values = jnp.zeros(grid_shape, jnp.float32)
    sa, name = sp.shard_axis, sp.state_axis_name
    pad_rows = sp.plan.query_shape[sa] - sp.state_size
    blk = sp.plan.query_shape[sa] // mesh.shape[name]
    n_checks = max(max_sweeps // check_every, 1)

    def run(v0, *flat):
        k = len(sp.plan.lo)
        plan_l = InterpPlan(tuple(flat[:k]), tuple(flat[k:2 * k]), grid_shape)
        cost = flat[2 * k]

        # rows of this block that are real (not state-axis padding)
        row0 = jax.lax.axis_index(name) * blk
        local_rows = row0 + jnp.arange(blk)
        row_mask_shape = [1] * (len(sp.plan.query_shape) - 1)
        row_mask_shape[sa] = blk
        row_mask = (local_rows < sp.state_size).reshape(row_mask_shape)

        block_state = tuple(
            (s // mesh.shape[name] if i == sa else s)
            for i, s in enumerate(sp.plan.query_shape[:-1])
        )

        def cond(carry):
            k_s, converged = carry[2], carry[4]
            return jnp.logical_and(k_s >= 1, jnp.logical_not(converged))

        def body(carry):
            v, _, k_s, (fsum_prev, usum_prev), _, checks, c_idx = carry
            vals, args = _local_backup(v, plan_l, cost, sp)
            v_new = jax.lax.all_gather(vals, name, axis=sa, tiled=True)
            if pad_rows:
                v_new = jax.lax.slice_in_dim(v_new, 0, sp.state_size, axis=sa)
            do_check = (k_s % check_every) == 0
            fsum = jnp.sum(v_new, dtype=jnp.float32)      # identical/device
            usum = jax.lax.psum(
                jnp.sum(jnp.where(row_mask, args, 0), dtype=jnp.float32),
                name)
            err_f = fsum - fsum_prev
            err_u = usum - usum_prev
            converged = jnp.logical_and(
                do_check, convergence_stop(err_f, fsum, tol, tol_mode))
            checks, c_idx = _record_check(do_check, k_s, err_f, err_u,
                                          checks, c_idx, on_check, name)
            fsum_prev = jnp.where(do_check, fsum, fsum_prev)
            usum_prev = jnp.where(do_check, usum, usum_prev)
            return (v_new, args, k_s - 1, (fsum_prev, usum_prev), converged,
                    checks, c_idx)

        init = (
            v0,
            jnp.zeros(block_state, jnp.int32),
            jnp.asarray(max_sweeps, jnp.int32),
            (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32)),
            jnp.asarray(False),
            jnp.zeros((n_checks, 3), jnp.float32),
            jnp.asarray(0, jnp.int32),
        )
        v_fin, args, k_s, _, converged, checks, _ = jax.lax.while_loop(
            cond, body, init)
        args_full = jax.lax.all_gather(args, name, axis=sa, tiled=True)
        if pad_rows:
            args_full = jax.lax.slice_in_dim(args_full, 0, sp.state_size,
                                             axis=sa)
        return v_fin, args_full, k_s, converged, checks

    in_specs = (P(),) + sp.in_specs
    out_specs = (P(), P(), P(), P(), P())
    fn = jax.shard_map(run, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    flat = tuple(sp.plan.lo) + tuple(sp.plan.frac) + (sp.cost,)
    values, argmin, k_s, converged, checks = jax.jit(fn)(init_values, *flat)
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=None,
        num_sweeps=jnp.asarray(max_sweeps, jnp.int32) - k_s,
        converged=converged,
        checks=checks,
    )


def value_iteration_finite_sharded(
    plan: InterpPlan,
    stage_cost: jax.Array,
    num_sweeps: int,
    mesh: Mesh,
    *,
    shard_axis: int = 0,
    state_axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[jax.Array] = None,
    store_policies: bool = False,
) -> SolveResult:
    """Mesh-sharded twin of :func:`ocdp_tpu.engine.value_iteration_finite`.

    Exact same results as the single-chip engine (tested bitwise in f32):
    sharding only re-tiles the query tensors; the arithmetic per query point
    and the reduction tie-breaking are unchanged.
    """
    sp = shard_backup_inputs(
        plan, stage_cost, mesh, shard_axis=shard_axis,
        state_axis_name=state_axis_name, action_axis_name=action_axis_name,
    )
    runner = partial(sharded_bellman_sweeps, sp, mesh, num_sweeps,
                     store_policies=store_policies)
    values, argmin, policies = jax.jit(runner)(init_values=init_values)
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=policies if store_policies else None,
        num_sweeps=jnp.asarray(num_sweeps, jnp.int32),
        converged=jnp.asarray(False),
    )
