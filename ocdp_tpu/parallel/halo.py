"""Halo-exchange sharded value iteration: the value table itself is sharded.

The replicated-table engine (``parallel/sharded.py``) all_gathers the whole
table every sweep — fine when the table is small next to the S x A query
work. For memory-bound grids (the 6-D attitude family, SURVEY.md §5
"long context" analog) the design is to keep each device's value
BLOCK resident and exchange only the **interpolation stencil boundary
slabs** with ring neighbors (`ppermute`) — functionally the
ring-attention neighbor pass:

* the state grid's axis 0 is blocked across the mesh axis; device d owns
  rows [d*b, (d+1)*b);
* the stencil's axis-0 band (pad widths = the dynamics' true reach,
  h*max|xdot| / cell size, computed at build time) gives the halo widths;
  each sweep every device sends its top rows left and bottom rows right —
  one bidirectional ppermute pair, nothing else moves;
* edge devices receive zeros from the missing neighbor, which matches the
  single-chip stencil's zero padding exactly (out-of-band taps have
  identically-zero weights);
* per-sweep traffic is O(halo x row) per device vs O(whole table) for
  the all_gather engine.

Requires halo width <= block height (reach spanning more than one neighbor
would need multi-hop exchange — raise and let the caller re-block).
Results are bitwise identical to the single-chip stencil backup.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import SolveResult, convergence_stop, policy_dtype_for
from ..ops.interp import InterpPlan
from ..ops.stencil import build_stencil_backup
from .sharded import _record_check

__all__ = ["value_iteration_finite_halo", "value_iteration_converged_halo"]


def _halo_pad_axis0(v_local, axis_name, lo, hi, n_dev):
    """Assemble [left_halo; v_local; right_halo] along axis 0.

    Left halo = bottom ``lo`` rows of the left neighbor; right halo = top
    ``hi`` rows of the right neighbor. Missing neighbors (grid edges)
    contribute zeros — ppermute's semantics for absent sources.
    """
    parts = []
    if lo:
        parts.append(jax.lax.ppermute(
            v_local[-lo:], axis_name, [(i, i + 1) for i in range(n_dev - 1)]))
    parts.append(v_local)
    if hi:
        parts.append(jax.lax.ppermute(
            v_local[:hi], axis_name, [(i + 1, i) for i in range(n_dev - 1)]))
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else v_local


def value_iteration_finite_halo(
    plan: InterpPlan,
    stage_cost,
    num_sweeps: int,
    mesh: Mesh,
    *,
    axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    action_chunk: Optional[int] = None,
    weight_mode: str = "onthefly",
    init_values: Optional[jax.Array] = None,
    store_policies: bool = False,
) -> SolveResult:
    """Finite-horizon value iteration with a sharded table + halo exchange.

    The state grid's axis 0 must be divisible by the mesh axis size. Returns
    global (unsharded) results identical to the single-chip stencil engine.

    ``action_axis_name``: optional SECOND mesh axis sharding the action-chunk
    axis (the TP analog composed with the CP/halo analog — a 2-D
    state x action mesh). Each device sweeps its action chunks over its row
    block; the winners combine with one ``all_gather`` + first-min over the
    action axis (device order along the axis = ascending action offset, so
    MATLAB first-minimum semantics hold across shards — same scheme as
    parallel/sharded.py). The table stays sharded over ``axis_name`` only
    and is replicated across the action axis; halos ppermute within each
    action column. Requires the chunk count to divide evenly across the
    action mesh axis.
    """
    n_dev = mesh.shape[axis_name]
    sb = build_stencil_backup(plan, stage_cost, action_chunk=action_chunk,
                              state_blocks=n_dev, weight_mode=weight_mode)
    if sb.edge_taps and (sb.edge_taps[0][0] or sb.edge_taps[0][1]):
        raise ValueError("axis-0 edge taps need global edge rows; "
                         "edge_split is not supported by the halo engine")
    lo0, hi0 = sb.pad[0]
    block0 = sb.block_shape[0]
    if max(lo0, hi0) > block0:
        raise ValueError(
            f"halo widths {sb.pad[0]} exceed the per-device block height "
            f"{block0}; use fewer devices or the all_gather engine")
    other_pads = ((0, 0),) + tuple(sb.pad[1:])
    grid_shape = sb.grid_shape
    state_ndim = len(sb.state_shape)

    n_chunks = sb.base.shape[1]
    n_act_dev = mesh.shape[action_axis_name] if action_axis_name else 1
    if action_axis_name:
        if n_chunks % n_act_dev:
            raise ValueError(
                f"{n_chunks} action chunks do not divide across the "
                f"{n_act_dev}-device action mesh axis; pick action_chunk so "
                f"n_actions/action_chunk is a multiple of the axis size")
        local_A = (n_chunks // n_act_dev) * sb.chunk

    if init_values is None:
        init_values = jnp.zeros(grid_shape, jnp.float32)

    def run(v_blk, offs, fracs, weights, costs, base):
        # shard_map hands each device its (1, C_local, ...) slice; strip B.
        local = jax.tree.map(lambda a: a[0], (offs, fracs, weights, costs, base))
        # slice starts are relative to the local padded table, so b_start=0
        xs = (jnp.zeros((state_ndim,), jnp.int32),) + local

        pdt = policy_dtype_for(sb.n_actions)

        def sweep(carry, _):
            v_local, _ = carry
            v_halo = _halo_pad_axis0(v_local, axis_name, lo0, hi0, n_dev)
            v_pad = jnp.pad(v_halo, other_pads)
            vals, args = sb.block_sweep(v_pad, xs)
            if action_axis_name:
                # local chunk argmin -> global flat action index, then
                # first-min combine across the action shards
                args = args + jax.lax.axis_index(action_axis_name) * local_A
                vals_g = jax.lax.all_gather(vals, action_axis_name)
                args_g = jax.lax.all_gather(args, action_axis_name)
                best = jnp.argmin(vals_g, axis=0)
                vals = jnp.take_along_axis(vals_g, best[None], axis=0)[0]
                args = jnp.take_along_axis(args_g, best[None], axis=0)[0]
            return (vals, args), (args.astype(pdt) if store_policies
                                  else None)

        init = (v_blk, jnp.zeros(sb.block_shape, jnp.int32))
        (v_fin, args), pols = jax.lax.scan(sweep, init, None,
                                           length=num_sweeps)
        if store_policies:
            return v_fin, args, pols
        return v_fin, args

    blocked = P(*([axis_name] + [None] * (state_ndim - 1)))

    def arr_spec_for(a):
        # Every stencil input carries (B, C, ...) leading axes — dim 0 is
        # the state-block axis, dim 1 IS the action-chunk axis by the
        # StencilBackup layout contract (ops/stencil.py:102-111). Shard it
        # explicitly rather than inferring from a size coincidence; a
        # future array violating the contract fails loudly here.
        parts = [axis_name] + [None] * (a.ndim - 1)
        if action_axis_name:
            if a.ndim < 2 or a.shape[1] != n_chunks:
                raise ValueError(
                    f"stencil input with shape {a.shape} does not carry the "
                    f"(B, C={n_chunks}, ...) chunk axis the action mesh "
                    "shards — StencilBackup layout contract violated")
            parts[1] = action_axis_name
        return P(*parts)

    arr_spec = jax.tree.map(
        arr_spec_for,
        (sb.off_res, sb.frac, sb.weights, sb.cost_blocked, sb.base),
    )
    in_specs = (blocked,) + arr_spec
    pol_spec = P(*([None, axis_name] + [None] * (state_ndim - 1)))
    out_specs = (blocked, blocked, pol_spec) if store_policies \
        else (blocked, blocked)

    fn = jax.shard_map(run, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    out = jax.jit(fn)(init_values, sb.off_res, sb.frac, sb.weights,
                      sb.cost_blocked, sb.base)
    values, argmin = out[0], out[1]
    policies = out[2] if store_policies else None
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=policies,
        num_sweeps=jnp.asarray(num_sweeps, jnp.int32),
        converged=jnp.asarray(False),
    )


def value_iteration_converged_halo(
    plan: InterpPlan,
    stage_cost,
    max_sweeps: int,
    mesh: Mesh,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    axis_name: str = "s",
    action_chunk: Optional[int] = None,
    weight_mode: str = "onthefly",
    init_values: Optional[jax.Array] = None,
    on_check=None,
) -> SolveResult:
    """Early-stopping twin of :func:`value_iteration_finite_halo`.

    ``on_check(k_s, errorF, errorU)`` streams each check to the host once
    (emitted from mesh coordinate 0; Solver_pos_att.m:278 print parity).

    The table never leaves its shards: the stop decision needs only the
    GLOBAL sums ``errorF = Δ Σ V`` / ``errorU = Δ Σ argmin`` — one scalar
    ``psum`` each over the mesh axis per sweep, identical on every device
    (pos-att/Solver_pos_att.m:268-286 semantics). Values/argmin are bitwise
    equal to the single-chip converged engine; the checksum itself can
    differ from the single-chip full-table sum by ~1 ulp (per-shard partial
    sums reduce in a different order), so a tolerance sitting exactly on an
    errorF value could in principle stop one check later.
    """
    n_dev = mesh.shape[axis_name]
    sb = build_stencil_backup(plan, stage_cost, action_chunk=action_chunk,
                              state_blocks=n_dev, weight_mode=weight_mode)
    if sb.edge_taps and (sb.edge_taps[0][0] or sb.edge_taps[0][1]):
        raise ValueError("axis-0 edge taps need global edge rows; "
                         "edge_split is not supported by the halo engine")
    lo0, hi0 = sb.pad[0]
    block0 = sb.block_shape[0]
    if max(lo0, hi0) > block0:
        raise ValueError(
            f"halo widths {sb.pad[0]} exceed the per-device block height "
            f"{block0}; use fewer devices or the all_gather engine")
    other_pads = ((0, 0),) + tuple(sb.pad[1:])
    grid_shape = sb.grid_shape
    state_ndim = len(sb.state_shape)
    n_checks = max(max_sweeps // check_every, 1)

    if init_values is None:
        init_values = jnp.zeros(grid_shape, jnp.float32)

    def run(v_blk, offs, fracs, weights, costs, base):
        local = jax.tree.map(lambda a: a[0], (offs, fracs, weights, costs, base))
        xs = (jnp.zeros((state_ndim,), jnp.int32),) + local

        def cond(carry):
            k_s, converged = carry[2], carry[4]
            return jnp.logical_and(k_s >= 1, jnp.logical_not(converged))

        def body(carry):
            v_local, _, k_s, (fsum_prev, usum_prev), _, checks, c_idx = carry
            v_halo = _halo_pad_axis0(v_local, axis_name, lo0, hi0, n_dev)
            v_pad = jnp.pad(v_halo, other_pads)
            vals, args = sb.block_sweep(v_pad, xs)
            do_check = (k_s % check_every) == 0
            fsum = jax.lax.psum(jnp.sum(vals, dtype=jnp.float32), axis_name)
            usum = jax.lax.psum(jnp.sum(args, dtype=jnp.float32), axis_name)
            err_f = fsum - fsum_prev
            err_u = usum - usum_prev
            converged = jnp.logical_and(
                do_check, convergence_stop(err_f, fsum, tol, tol_mode))
            checks, c_idx = _record_check(do_check, k_s, err_f, err_u,
                                          checks, c_idx, on_check, axis_name)
            fsum_prev = jnp.where(do_check, fsum, fsum_prev)
            usum_prev = jnp.where(do_check, usum, usum_prev)
            return (vals, args, k_s - 1, (fsum_prev, usum_prev), converged,
                    checks, c_idx)

        init = (
            v_blk,
            jnp.zeros(sb.block_shape, jnp.int32),
            jnp.asarray(max_sweeps, jnp.int32),
            (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32)),
            jnp.asarray(False),
            jnp.zeros((n_checks, 3), jnp.float32),
            jnp.asarray(0, jnp.int32),
        )
        v_fin, args, k_s, _, converged, checks, _ = jax.lax.while_loop(
            cond, body, init)
        return v_fin, args, k_s, converged, checks

    blocked = P(*([axis_name] + [None] * (state_ndim - 1)))
    arr_spec = jax.tree.map(
        lambda a: P(*([axis_name] + [None] * (a.ndim - 1))),
        (sb.off_res, sb.frac, sb.weights, sb.cost_blocked, sb.base),
    )
    in_specs = (blocked,) + arr_spec
    out_specs = (blocked, blocked, P(), P(), P())
    fn = jax.shard_map(run, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    values, argmin, k_s, converged, checks = jax.jit(fn)(
        init_values, sb.off_res, sb.frac, sb.weights, sb.cost_blocked, sb.base)
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=None,
        num_sweeps=jnp.asarray(max_sweeps, jnp.int32) - k_s,
        converged=converged,
        checks=checks,
    )
