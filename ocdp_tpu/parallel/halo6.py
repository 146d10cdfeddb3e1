"""Row-sharded 6-D attitude value iteration: halo exchange + row/lane kernel.

Scales the flagship full-attitude solve (attitude-control/
Solver_attitude.m:261-300) past one device: the single-device row/lane
kernel (``ops/pallas_backup6.py``) holds the (omega-rows x Euler-lanes)
value table on one device; past one device's memory or for wall-clock
scaling, here the table's ROW axis (the flat omega index) is sharded
across a mesh axis; each sweep exchanges only the kernel's row-tap reach
with its neighbors (`ppermute`) — the same boundary-slab pattern as
``parallel/halo.py``, at 6-D scale:

* device d owns rows [d*B, (d+1)*B) of the (NWp = n_dev*B)-row table;
* left halo = bottom ``pad_top`` rows of the left neighbor, right halo =
  top ``pad_bot`` rows of the right neighbor (widths = the kernel's flat
  row-tap span, known at build time);
* edge devices receive ppermute's zeros, matching the single-chip zero
  padding exactly; out-of-range taps carry identically-zero weights, so
  rows/lanes of padding garbage contribute exact zeros — results are
  BITWISE identical to the single-chip kernel;
* per-sweep traffic is O(halo rows x NEp) per device; the table block and
  offset/weight slices stay device-resident.

Requires halo width <= per-device block height (the reach never spans more
than the immediate neighbor); raise otherwise and use fewer devices.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import SolveResult, convergence_stop, policy_dtype_for
from ..ops.interp import InterpPlan
from ..ops.pallas_backup6 import DEFAULT_ROW_TILE, PallasBackup6D, _round_up
from .sharded import _record_check

__all__ = ["value_iteration_finite_halo6", "value_iteration_converged_halo6"]


def _build_rowsharded(plan: InterpPlan, cost_terms, n_dev: int, kernel_kw):
    """Kernel + per-device block height for an ``n_dev``-way row shard."""
    row_axes = kernel_kw.get("row_axes", 3)
    if kernel_kw.get("carry_padded"):
        raise ValueError("carry_padded is a single-chip engine mode; the "
                         "halo engines manage their own padded windows")
    # flat plans (big on-device builds) carry (rows, lanes, A) arrays;
    # the grid's true state shape always comes from grid_shape
    flat = len(plan.query_shape) != plan.ndim + 1
    state_shape = plan.grid_shape if flat else plan.query_shape[:-1]
    NW = int(np.prod(state_shape[:row_axes]))
    T = kernel_kw.get("row_tile") or DEFAULT_ROW_TILE
    B = _round_up(-(-NW // n_dev), T)            # block rows, whole tiles
    kw = dict(kernel_kw, row_tile=T, row_pad_to=n_dev * B)
    bk = PallasBackup6D(plan, cost_terms, **kw)
    lo, hi = bk.pad_top, bk.pad_bot
    if max(lo, hi) > B:
        raise ValueError(
            f"halo widths ({lo}, {hi}) exceed the per-device block height "
            f"{B}; use fewer devices")
    return bk, B, lo, hi


def _slice_plan_actions(plan, sl: slice):
    """A plan restricted to an action-index slice (arrays with a singleton
    action axis are shared by every action and pass through)."""
    def cut(a):
        return a[..., sl] if a.shape[-1] > 1 else a

    return InterpPlan(tuple(cut(x) for x in plan.lo),
                      tuple(cut(x) for x in plan.frac), plan.grid_shape)


def _build_actsharded(plan, cost_terms, n_dev_s: int, n_a: int, kernel_kw):
    """Per-action-group kernels with ONE shared treedef, leaf-stacked for a
    2-D (rows x actions) mesh (the CP x TP composition; VERDICT r3 item 6).

    The 27-action contraction splits into ``n_a`` contiguous ascending
    groups of ``n_act/n_a`` actions; each group's kernel is rebuilt against
    the union tap structure (zero-weight extras — output unchanged) with
    per-action costs in the traced row x action bucket, so the stacked
    pytree shard_maps as one program. Group argmins combine with the
    ascending-offset first-min rule (see the engines), preserving the
    single-chip flat C-order first minimum bitwise.
    """
    from ..ops.pallas_backup6 import union_live_sets

    terms = (list(cost_terms) if isinstance(cost_terms, (tuple, list))
             else [cost_terms])
    n_act = plan.query_shape[-1]
    if n_act % n_a:
        raise ValueError(
            f"{n_act} actions do not split over {n_a} action-mesh devices")
    k = n_act // n_a
    groups = []
    for g in range(n_a):
        sl = slice(g * k, (g + 1) * k)
        p_g = _slice_plan_actions(plan, sl)
        c_g = [t[..., sl] if jnp.ndim(t) and jnp.shape(t)[-1] > 1 else t
               for t in terms]
        groups.append((p_g, c_g))

    def build(g, extra):
        kw = dict(kernel_kw, cost_act_traced=True, **extra)
        return _build_rowsharded(groups[g][0], groups[g][1], n_dev_s, kw)

    # digit-slice mode: when the full action set is digit-factorized with
    # m == n_a (the attitude 27 = 3^3 over 3 devices), each group is a
    # fixed-d0 slice and runs the SAME factorized contraction as the
    # single-chip kernel — group outputs then match its rounding bitwise.
    # EVERY group must validate (the layout checks can pass for slice 0
    # yet fail for a later one, and the stacked leaves need one treedef);
    # any failure falls back to the generic order for ALL groups (still
    # exact to ~ulp, no longer bitwise). The successful validation pass
    # IS the first build — no throwaway probe construction.
    digit_kw = {}
    first = None
    if k == n_a * n_a:
        try:
            first = [build(g, {"digit_slice": n_a}) for g in range(n_a)]
            digit_kw = {"digit_slice": n_a}
        except ValueError:
            first = None
    if first is None:
        first = [build(g, digit_kw) for g in range(n_a)]
    union = union_live_sets([b for b, _, _, _ in first])
    built = [build(g, dict(digit_kw, live_sets=union)) for g in range(n_a)]
    bks = [b for b, _, _, _ in built]
    tds = {jax.tree_util.tree_structure(b) for b in bks}
    if len(tds) != 1:
        raise AssertionError(f"action-group kernels did not unify: {tds}")
    _, B, lo, hi = built[0]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *bks)
    return bks[0], stacked, k, B, lo, hi


def _act_specs(bk, stacked, s_ax: str, a_ax: str):
    """in_specs tree for the leaf-stacked backup: per-row leaves shard
    (action, rows, ...), replicated leaves (action, ...). Leaf order ==
    sweep_args order (_LEAF_FIELDS matches it by construction)."""
    leaves, treedef = jax.tree_util.tree_flatten(stacked)
    n_rep = bk.n_replicated_args
    specs = []
    for i, x in enumerate(leaves):
        if i < len(leaves) - n_rep:
            specs.append(P(a_ax, s_ax, *([None] * (x.ndim - 2))))
        else:
            specs.append(P(a_ax, *([None] * (x.ndim - 1))))
    return jax.tree_util.tree_unflatten(treedef, specs)


def _combine_first_min(vals_g, argm_g, k: int, n_act: int, a_ax: str):
    """Ascending-offset first-min combine across the action mesh axis:
    elementwise min of group minima; among groups achieving it, the
    smallest GLOBAL action index wins — exactly the single-chip flat
    C-order first minimum (groups are contiguous ascending slices and each
    kernel already returns its local first-min)."""
    offset = jax.lax.axis_index(a_ax).astype(jnp.int32) * k
    argm_glob = argm_g.astype(jnp.int32) + offset
    vmin = jax.lax.pmin(vals_g, a_ax)
    cand = jnp.where(vals_g == vmin, argm_glob, jnp.int32(n_act))
    return vmin, jax.lax.pmin(cand, a_ax)


def _make_halo_pad(axis_name: str, n_dev: int, lo: int, hi: int):
    def halo_pad(v_local):
        parts = []
        if lo:
            parts.append(jax.lax.ppermute(
                v_local[-lo:], axis_name,
                [(i, i + 1) for i in range(n_dev - 1)]))
        parts.append(v_local)
        if hi:
            parts.append(jax.lax.ppermute(
                v_local[:hi], axis_name,
                [(i + 1, i) for i in range(n_dev - 1)]))
        return jnp.concatenate(parts, axis=0) if len(parts) > 1 \
            else v_local
    return halo_pad


def value_iteration_finite_halo6(
    plan: InterpPlan,
    cost_terms,
    num_sweeps: int,
    mesh: Mesh,
    *,
    axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[jax.Array] = None,
    store_policies: bool = False,
    **kernel_kw,
) -> SolveResult:
    """Finite-horizon VI, table row-sharded over ``mesh[axis_name]``.

    Returns global (unsharded) results bitwise identical to running the
    single-chip :class:`PallasBackup6D` through the finite engine.

    ``action_axis_name``: optional second mesh axis sharding the action
    contraction (CP x TP composition, as ``parallel/halo.py`` does for the
    stencil): each device computes its contiguous action group's first-min
    and groups combine with the ascending-offset first-min rule —
    still bitwise vs single-chip.
    """
    if action_axis_name is not None:
        return _finite_halo6_2d(plan, cost_terms, num_sweeps, mesh,
                                axis_name, action_axis_name, init_values,
                                store_policies, kernel_kw)
    n_dev = mesh.shape[axis_name]
    bk, B, lo, hi = _build_rowsharded(plan, cost_terms, n_dev, kernel_kw)

    if init_values is None:
        v0 = jnp.zeros((bk.NWp, bk.NEp), jnp.float32)
    else:
        v0 = jnp.pad(init_values.reshape(bk.NW, bk.NE),
                     ((0, bk.NWp - bk.NW), (0, bk.NEp - bk.NE)))
    pdt = policy_dtype_for(bk.n_actions)

    def run(v_blk, *args_l):
        halo_pad = _make_halo_pad(axis_name, n_dev, lo, hi)

        def sweep(carry, _):
            v_local, _ = carry
            v2p = halo_pad(v_local)
            vals, argm = bk._sweep_padded(v2p, args_l, B)
            return (vals, argm), (argm.astype(pdt) if store_policies
                                  else None)

        init = (v_blk, jnp.zeros((B, bk.NEp), bk.argmin_dtype))
        (v_fin, argm), pols = jax.lax.scan(sweep, init, None,
                                           length=num_sweeps)
        if store_policies:
            return v_fin, argm, pols
        return v_fin, argm

    rows = P(axis_name, None)
    n_rep = bk.n_replicated_args
    in_specs = [rows]
    for a in bk.sweep_args[:-n_rep]:
        in_specs.append(rows)
    # lane feats + c_lane: replicated
    in_specs += [P(None, None)] * n_rep
    out_specs = (rows, rows, P(None, axis_name, None)) if store_policies \
        else (rows, rows)

    fn = jax.shard_map(run, mesh=mesh, in_specs=tuple(in_specs),
                       out_specs=out_specs, check_vma=False)
    out = jax.jit(fn)(v0, *bk.sweep_args)
    values = out[0][:bk.NW, :bk.NE].reshape(bk.state_shape)
    # SolveResult contract: int32 argmin (engine.py) — the kernel may emit
    # a narrow argmin_dtype (uint8 envelope mode); match the 2-D twins
    argmin = out[1][:bk.NW, :bk.NE].reshape(bk.state_shape).astype(jnp.int32)
    policies = None
    if store_policies:
        policies = out[2][:, :bk.NW, :bk.NE].reshape(
            (num_sweeps,) + bk.state_shape)
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=policies,
        num_sweeps=jnp.asarray(num_sweeps, jnp.int32),
        converged=jnp.asarray(False),
    )


def _finite_halo6_2d(plan, cost_terms, num_sweeps, mesh, s_ax, a_ax,
                     init_values, store_policies, kernel_kw):
    """2-D-mesh (rows x action-groups) twin of the finite halo6 engine."""
    n_s, n_a = mesh.shape[s_ax], mesh.shape[a_ax]
    bk, stacked, k, B, lo, hi = _build_actsharded(plan, cost_terms, n_s,
                                                  n_a, kernel_kw)
    n_act = k * n_a
    pdt = policy_dtype_for(n_act)
    if init_values is None:
        v0 = jnp.zeros((bk.NWp, bk.NEp), jnp.float32)
    else:
        v0 = jnp.pad(init_values.reshape(bk.NW, bk.NE),
                     ((0, bk.NWp - bk.NW), (0, bk.NEp - bk.NE)))

    def run(v_blk, stk):
        bk_l = jax.tree.map(lambda x: x[0], stk)
        halo_pad = _make_halo_pad(s_ax, n_s, lo, hi)

        def sweep(carry, _):
            v_local, _ = carry
            v2p = halo_pad(v_local)
            vals_g, argm_g = bk_l._sweep_padded(v2p, bk_l.sweep_args, B)
            vals, argm = _combine_first_min(vals_g, argm_g, k, n_act, a_ax)
            argm = argm.astype(pdt)
            return (vals, argm), (argm if store_policies else None)

        init = (v_blk, jnp.zeros((B, bk.NEp), pdt))
        (v_fin, argm), pols = jax.lax.scan(sweep, init, None,
                                           length=num_sweeps)
        if store_policies:
            return v_fin, argm, pols
        return v_fin, argm

    rows = P(s_ax, None)
    in_specs = (rows, _act_specs(bk, stacked, s_ax, a_ax))
    out_specs = (rows, rows, P(None, s_ax, None)) if store_policies \
        else (rows, rows)
    fn = jax.shard_map(run, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    out = jax.jit(fn)(v0, stacked)
    values = out[0][:bk.NW, :bk.NE].reshape(bk.state_shape)
    argmin = out[1][:bk.NW, :bk.NE].astype(jnp.int32).reshape(bk.state_shape)
    policies = None
    if store_policies:
        policies = out[2][:, :bk.NW, :bk.NE].reshape(
            (num_sweeps,) + bk.state_shape)
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=policies,
        num_sweeps=jnp.asarray(num_sweeps, jnp.int32),
        converged=jnp.asarray(False),
    )


def _converged_halo6_2d(plan, cost_terms, max_sweeps, mesh, s_ax, a_ax,
                        check_every, tol, tol_mode, init_values, on_check,
                        kernel_kw):
    """2-D-mesh (rows x action-groups) twin of the converged halo6 engine.

    Checksums psum over the ROW axis only (values/argmin are replicated
    across the action axis after the first-min combine), so every device
    on the 2-D mesh makes the identical stopping decision."""
    n_s, n_a = mesh.shape[s_ax], mesh.shape[a_ax]
    bk, stacked, k, B, lo, hi = _build_actsharded(plan, cost_terms, n_s,
                                                  n_a, kernel_kw)
    n_act = k * n_a
    pdt = policy_dtype_for(n_act)
    n_checks = max(max_sweeps // check_every, 1)
    if init_values is None:
        v0 = jnp.zeros((bk.NWp, bk.NEp), jnp.float32)
    else:
        v0 = jnp.pad(init_values.reshape(bk.NW, bk.NE),
                     ((0, bk.NWp - bk.NW), (0, bk.NEp - bk.NE)))

    def run(v_blk, stk):
        bk_l = jax.tree.map(lambda x: x[0], stk)
        halo_pad = _make_halo_pad(s_ax, n_s, lo, hi)
        row0 = jax.lax.axis_index(s_ax) * B
        valid = ((row0 + jnp.arange(B))[:, None] < bk.NW) & \
            (jnp.arange(bk.NEp)[None, :] < bk.NE)

        def cond(carry):
            k_s, converged = carry[2], carry[4]
            return jnp.logical_and(k_s >= 1, jnp.logical_not(converged))

        def body(carry):
            v_local, _, k_s, (fsum_prev, usum_prev), _, checks, c_idx = carry
            v2p = halo_pad(v_local)
            vals_g, argm_g = bk_l._sweep_padded(v2p, bk_l.sweep_args, B)
            vals, argm = _combine_first_min(vals_g, argm_g, k, n_act, a_ax)
            argm = argm.astype(pdt)
            do_check = (k_s % check_every) == 0
            fsum = jax.lax.psum(
                jnp.sum(jnp.where(valid, vals, 0.0), dtype=jnp.float32),
                s_ax)
            usum = jax.lax.psum(
                jnp.sum(jnp.where(valid, argm, 0).astype(jnp.float32),
                        dtype=jnp.float32),
                s_ax)
            err_f = fsum - fsum_prev
            err_u = usum - usum_prev
            converged = jnp.logical_and(
                do_check, convergence_stop(err_f, fsum, tol, tol_mode))
            checks, c_idx = _record_check(do_check, k_s, err_f, err_u,
                                          checks, c_idx, on_check, s_ax)
            fsum_prev = jnp.where(do_check, fsum, fsum_prev)
            usum_prev = jnp.where(do_check, usum, usum_prev)
            return (vals, argm, k_s - 1, (fsum_prev, usum_prev), converged,
                    checks, c_idx)

        init = (
            v_blk,
            jnp.zeros((B, bk.NEp), pdt),
            jnp.asarray(max_sweeps, jnp.int32),
            (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32)),
            jnp.asarray(False),
            jnp.zeros((n_checks, 3), jnp.float32),
            jnp.asarray(0, jnp.int32),
        )
        v_fin, argm, k_s, _, converged, checks, _ = jax.lax.while_loop(
            cond, body, init)
        return v_fin, argm, k_s, converged, checks

    rows = P(s_ax, None)
    in_specs = (rows, _act_specs(bk, stacked, s_ax, a_ax))
    out_specs = (rows, rows, P(), P(), P())
    fn = jax.shard_map(run, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    out = jax.jit(fn)(v0, stacked)
    values = out[0][:bk.NW, :bk.NE].reshape(bk.state_shape)
    argmin = out[1][:bk.NW, :bk.NE].astype(jnp.int32).reshape(bk.state_shape)
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=None,
        num_sweeps=jnp.asarray(max_sweeps, jnp.int32) - out[2],
        converged=out[3],
        checks=out[4],
    )


def value_iteration_converged_halo6(
    plan: InterpPlan,
    cost_terms,
    max_sweeps: int,
    mesh: Mesh,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[jax.Array] = None,
    on_check=None,
    **kernel_kw,
) -> SolveResult:
    """Early-stopping twin of :func:`value_iteration_finite_halo6`.

    ``on_check(k_s, errorF, errorU)`` streams each check to the host once
    (emitted from mesh coordinate 0; Solver_pos_att.m:278 print parity).

    The reference's periodic-checksum stop (pos-att/Solver_pos_att.m:268-286
    semantics, applied to the 6-D attitude table): every ``check_every``
    sweeps compare ``errorF = Δ Σ V`` / ``errorU = Δ Σ argmin`` and stop when
    ``|errorF| < tol``. The table never leaves its row shards — the checksums
    are one scalar ``psum`` each over the mesh axis, so every device makes
    the identical stopping decision. Padding rows/lanes (the kernel tiles to
    whole row tiles and lane blocks) are masked out of the sums, so the
    checksums match the single-chip converged engine up to shard reduction
    order (~1 ulp); values/argmin are bitwise equal to single-chip.

    ``action_axis_name``: optional second mesh axis sharding the action
    contraction (see :func:`value_iteration_finite_halo6`).
    """
    if action_axis_name is not None:
        return _converged_halo6_2d(plan, cost_terms, max_sweeps, mesh,
                                   axis_name, action_axis_name, check_every,
                                   tol, tol_mode, init_values, on_check,
                                   kernel_kw)
    n_dev = mesh.shape[axis_name]
    bk, B, lo, hi = _build_rowsharded(plan, cost_terms, n_dev, kernel_kw)
    n_checks = max(max_sweeps // check_every, 1)

    if init_values is None:
        v0 = jnp.zeros((bk.NWp, bk.NEp), jnp.float32)
    else:
        v0 = jnp.pad(init_values.reshape(bk.NW, bk.NE),
                     ((0, bk.NWp - bk.NW), (0, bk.NEp - bk.NE)))

    def run(v_blk, *args_l):
        halo_pad = _make_halo_pad(axis_name, n_dev, lo, hi)
        # mask of REAL cells in this device's (B, NEp) block: the kernel
        # pads rows to whole tiles / lanes to whole blocks and writes
        # garbage there
        # (zero-weight taps keep it out of real cells); it must not reach
        # the convergence checksums
        row0 = jax.lax.axis_index(axis_name) * B
        valid = ((row0 + jnp.arange(B))[:, None] < bk.NW) & \
            (jnp.arange(bk.NEp)[None, :] < bk.NE)

        def cond(carry):
            k_s, converged = carry[2], carry[4]
            return jnp.logical_and(k_s >= 1, jnp.logical_not(converged))

        def body(carry):
            v_local, _, k_s, (fsum_prev, usum_prev), _, checks, c_idx = carry
            v2p = halo_pad(v_local)
            vals, argm = bk._sweep_padded(v2p, args_l, B)
            do_check = (k_s % check_every) == 0
            fsum = jax.lax.psum(
                jnp.sum(jnp.where(valid, vals, 0.0), dtype=jnp.float32),
                axis_name)
            usum = jax.lax.psum(
                jnp.sum(jnp.where(valid, argm, 0).astype(jnp.float32),
                        dtype=jnp.float32),
                axis_name)
            err_f = fsum - fsum_prev
            err_u = usum - usum_prev
            converged = jnp.logical_and(
                do_check, convergence_stop(err_f, fsum, tol, tol_mode))
            checks, c_idx = _record_check(do_check, k_s, err_f, err_u,
                                          checks, c_idx, on_check, axis_name)
            fsum_prev = jnp.where(do_check, fsum, fsum_prev)
            usum_prev = jnp.where(do_check, usum, usum_prev)
            return (vals, argm, k_s - 1, (fsum_prev, usum_prev), converged,
                    checks, c_idx)

        init = (
            v_blk,
            jnp.zeros((B, bk.NEp), bk.argmin_dtype),
            jnp.asarray(max_sweeps, jnp.int32),
            (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32)),
            jnp.asarray(False),
            jnp.zeros((n_checks, 3), jnp.float32),
            jnp.asarray(0, jnp.int32),
        )
        v_fin, argm, k_s, _, converged, checks, _ = jax.lax.while_loop(
            cond, body, init)
        return v_fin, argm, k_s, converged, checks

    rows = P(axis_name, None)
    n_rep = bk.n_replicated_args
    in_specs = [rows] + [rows] * (len(bk.sweep_args) - n_rep) \
        + [P(None, None)] * n_rep
    out_specs = (rows, rows, P(), P(), P())
    fn = jax.shard_map(run, mesh=mesh, in_specs=tuple(in_specs),
                       out_specs=out_specs, check_vma=False)
    out = jax.jit(fn)(v0, *bk.sweep_args)
    values = out[0][:bk.NW, :bk.NE].reshape(bk.state_shape)
    argmin = out[1][:bk.NW, :bk.NE].reshape(bk.state_shape).astype(jnp.int32)
    return SolveResult(
        values=values,
        argmin=argmin,
        policies=None,
        num_sweeps=jnp.asarray(max_sweeps, jnp.int32) - out[2],
        converged=out[3],
        checks=out[4],
    )
