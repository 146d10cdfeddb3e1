"""Gather-free Bellman backup: banded-stencil interpolation via shifted slices.

The generic backup (``ops/backup.py``) evaluates J_{k+1}(f(x,u)) with 2^d
corner *gathers* — correct everywhere, but large random gathers are the
slowest memory pattern an accelerator has, which caps the whole solver. This
module exploits the structure the reference's problems all share: queries are
laid out on the state grid itself, and the next state lands only a bounded
number of cells away from the source cell (reach = h·max|ẋ| / cell size,
SURVEY.md §7 "hard parts"). Then for every tap offset δ in a small static
band, the corner read ``V[i + δ]`` is a **statically shifted slice** of the
(padded) value table — a pure elementwise mul-add sweep, no gather at all:

    interp(V)[i, a] = Σ_{δ1..δd in band} Π_k w_k(δ_k; i, a) · V[i1+δ1, ..., id+δd]

with per-axis tap weights w_k(δ) = [off_k == δ]·(1-frac_k) + [off_k == δ-1]·frac_k
(only 2 nonzero per query, so the sum is exact multilinear interpolation with
MATLAB extrapolation semantics inherited from the plan's unclamped fracs).

Two tiling axes bound the working set (both are ``lax.scan`` loops inside one
XLA computation):

* **Action chunking**: problems whose control term moves queries many cells
  (Kirk: B·u spans ~49 cells of the x2 axis over the 1000-control range) get
  a per-chunk integer **base shift** (a ``dynamic_slice`` start) so the
  residual band stays narrow; running (min, argmin) combine across chunks by
  strict ``<``, preserving MATLAB first-minimum tie-breaking.
* **State blocking** (``state_blocks``): the output grid is swept in blocks
  — an int blocks state axis 0, a tuple blocks any subset of state axes.
  Two distinct wins: (a) tiling that keeps the fused stencil tree's
  intermediates bounded for big grids, and (b) **band narrowing** — each
  (block, chunk) gets its own integer base, so query-offset drift
  *across* blocks (Kirk's x2 queries drift with both x1 and x2, inflating
  the global band to 47 taps) is absorbed by the base and the residual
  band only spans the within-block drift. The value table itself stays
  whole (any block may read any of it after a large control shift).

All band/base analysis happens once on the host at build time; per-sweep
work is elementwise f32 plus static/dynamic slices. Tap values whose
weight is provably zero for every query are pruned from the tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .backup import BackupResult
from .interp import InterpPlan

__all__ = ["StencilBackup", "build_stencil_backup"]


def _chunk_axis(arr: np.ndarray, n_chunks: int, chunk: int) -> np.ndarray:
    """Reshape the trailing action axis A -> leading (n_chunks, ..., chunk)."""
    shp = arr.shape
    out = arr.reshape(shp[:-1] + (n_chunks, chunk))
    return np.moveaxis(out, -2, 0)


def _block_axes(arr: np.ndarray, nbs: tuple[int, ...]) -> np.ndarray:
    """(C, s0..s_{d-1}, tail...) -> (B, C, bs0..bs_{d-1}, tail...).

    ``nbs[k]`` blocks state axis k into that many pieces; B = prod(nbs) in
    C-order over block coordinates. Broadcast-singleton state axes stay
    singleton inside a block and replicate across that axis's blocks —
    every block sees the same (shared) slice.
    """
    d = len(nbs)
    state = arr.shape[1:1 + d]
    tail = arr.shape[1 + d:]
    newshape = [arr.shape[0]]
    for n, nb in zip(state, nbs):
        newshape += ([1, 1] if n == 1 else [nb, n // nb])
    r = arr.reshape(newshape + list(tail))
    # block axes sit at 1, 3, 5, ...; gather them in front of C
    perm = ([1 + 2 * k for k in range(d)] + [0]
            + [2 + 2 * k for k in range(d)]
            + list(range(1 + 2 * d, r.ndim)))
    r = np.transpose(r, perm)
    full = tuple(nbs) + r.shape[d:]
    r = np.broadcast_to(r, full)
    return r.reshape((int(np.prod(nbs)),) + r.shape[d:])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StencilBackup:
    """Precomputed banded-stencil backup operator (one problem, fixed plan).

    Call with the current value table to get one Bellman sweep:
    ``StencilBackup.__call__(values) -> BackupResult``.

    Array layout: every per-chunk array carries leading (B, C) axes — state
    block and action chunk — over a state-BLOCK-shaped remainder.
    """

    off_res: tuple[jax.Array, ...]   # per axis: (B, C, *block_bcast, chunk) int32
    frac: tuple[jax.Array, ...]      # per axis: same layout, f32
    # weight_mode="precomputed": per axis, per live tap, the dense weight
    # array (B, C, ...) — built on host once; off_res/frac are then empty.
    # Keeps executables small (no foldable constants) AND avoids per-sweep
    # weight recomputation; costs HBM for the dense stacks.
    weights: tuple[tuple[jax.Array, ...], ...]
    base: jax.Array                  # (B, C, d) int32 per-(block, chunk) slice base
    block_starts: jax.Array          # (B, d) int32 per-axis output offsets
    cost_blocked: tuple[jax.Array, ...]  # terms with (B, C) leading axes
    cost_static: tuple[jax.Array, ...]   # fully broadcast terms (no B/C)
    # static metadata
    grid_shape: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    state_shape: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    block_shape: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    taps: tuple[tuple[int, int], ...] = dataclasses.field(metadata=dict(static=True))
    valid_taps: tuple[tuple[int, ...], ...] = dataclasses.field(metadata=dict(static=True))
    pad: tuple[tuple[int, int], ...] = dataclasses.field(metadata=dict(static=True))
    chunk: int = dataclasses.field(metadata=dict(static=True))
    n_actions: int = dataclasses.field(metadata=dict(static=True))
    # rolled flat-shift mode: taps swept by nested lax.scan over a FLAT view
    # of the table (offsets compose linearly across axes; wrapped reads pair
    # with exactly-zero weights). HLO is O(d * taps) instead of O(prod taps).
    rolled: bool = dataclasses.field(default=False, metadata=dict(static=True))
    strides: tuple[int, ...] = dataclasses.field(default=(), metadata=dict(static=True))
    flat_pad: tuple[int, int] = dataclasses.field(default=(0, 0), metadata=dict(static=True))
    # clamp-split: per axis (has_low_extrap, has_high_extrap). When set, the
    # interior band covers only non-extrapolating queries; queries clamped
    # past a grid edge are served by 4 FIXED-index edge taps whose weights
    # derive from frac<0 / frac>1 masks at runtime. This stops boundary
    # extrapolation from inflating the band (Kirk axis 1: 47 -> ~22 taps).
    edge_taps: tuple[tuple[bool, bool], ...] = dataclasses.field(
        default=(), metadata=dict(static=True))
    # blocks per state axis (multi-axis state blocking). () means axis-0-only
    # legacy blocking with B = block_starts.shape[0] blocks.
    n_blocks_per_axis: tuple[int, ...] = dataclasses.field(
        default=(), metadata=dict(static=True))
    # sweep blocks as unrolled Python loop instead of lax.map: all blocks
    # fuse into one XLA computation (no per-block while-loop overhead, XLA
    # may interleave them) at the price of B x larger HLO. The narrow-band
    # win of blocking only pays this way when a loop iteration's fixed
    # cost dwarfs a small block's compute.
    unroll_blocks: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # select-then-lerp tap combine: one compare + two selects per tap and a
    # single lerp per axis, instead of the per-tap weight formula that
    # XLA's fusion re-evaluates inside every consumer leaf — fewer vector ops
    # at wide bands. Mathematically identical (zeros add exactly), but NOT
    # bitwise-stable across program shapes: the two muls feeding one add
    # give the compiler a choice of which to contract into an FMA, and the
    # choice varies between e.g. blocked and unblocked builds (observed
    # ~1-ulp diffs halo vs single-chip). Default off — the sharded/halo
    # engines' bitwise==single-chip contract relies on the default form.
    lerp_select: bool = dataclasses.field(
        default=False, metadata=dict(static=True))

    def block_sweep(self, v_pad: jax.Array, xs):
        """One output block's fused min/argmin sweep against ``v_pad``.

        ``v_pad`` is the value table padded by ``self.pad`` (in the halo
        engine the axis-0 padding is neighbor-exchanged halo slabs instead).
        ``xs = (b_start, offs, fracs, weights, costs, base)`` with the
        leading (B,) axis already stripped; ``b_start`` is the (d,) vector
        of this block's per-axis output origins.
        """
        d = len(self.grid_shape)
        b_start, offs_b, fracs_b, weights_b, costs_b, base_b = xs

        def chunk_step(carry, cxs):
            best_v, best_a, a_offset = carry
            (offs, fracs, weights, costs), base = cxs
            total = self._chunk_total(v_pad, b_start, offs, fracs, weights,
                                      costs, base)
            m, a = self._chunk_min(total)
            a = a + a_offset
            better = m < best_v  # strict: earlier chunk wins ties
            return (jnp.where(better, m, best_v),
                    jnp.where(better, a, best_a),
                    a_offset + self.chunk), None

        init = (jnp.full(self.block_shape, jnp.inf, jnp.float32),
                jnp.zeros(self.block_shape, jnp.int32),
                jnp.asarray(0, jnp.int32))
        (vals, args, _), _ = jax.lax.scan(
            chunk_step, init,
            ((offs_b, fracs_b, weights_b, costs_b), base_b))
        return vals, args

    def _chunk_min(self, total):
        """First-min value + index over the trailing action axis.

        Kept as the fused ``min``/``argmin`` reduce: an unrolled strict-<
        chain over ``total[..., a]`` slices was tried against the pos-att
        profile (the 9-wide minor-axis iota-reduce is 57% of that solve)
        and REGRESSED 2x — minor-dim slices materialize as relayout
        copies, costing more than the narrow reduce they replace.
        """
        return (jnp.min(total, axis=-1),
                jnp.argmin(total, axis=-1).astype(jnp.int32))

    def _chunk_total(self, v_pad, b_start, offs, fracs, weights, costs, base):
        """One (block, chunk) tile's cost-plus-interpolated-value tensor,
        shape ``block_shape + (chunk,)`` — the argument of the Bellman min."""
        d = len(self.grid_shape)
        if self.rolled:
            total = self._rolled_interp(v_pad, b_start, offs, fracs, base)
            for term in costs:
                total = total + term
            for term in self.cost_static:
                total = total + term
            return jnp.broadcast_to(total,
                                    self.block_shape + (self.chunk,))

        split = bool(self.edge_taps) and any(
            lo or hi for lo, hi in self.edge_taps)
        wstacks = []
        if self.weights:
            for k in range(d):
                ws = {}
                for i, t in enumerate(self.valid_taps[k]):
                    ws[t] = weights[k][i]
                wstacks.append(ws)
        inms = [None] * d
        if split:
            for k in range(d):
                f = fracs[k]
                inms[k] = (f >= 0.0) & (f <= 1.0)

        # fixed-index edge-tap weights (extrapolating queries only)
        edge_terms = [()] * d
        if split:
            for k in range(d):
                has_lo, has_hi = self.edge_taps[k]
                f = fracs[k]
                terms_k = []
                if has_lo:
                    elow = f < 0.0
                    terms_k.append((jnp.where(elow, 1.0 - f, 0.0), "lo", 0))
                    terms_k.append((jnp.where(elow, f, 0.0), "lo", 1))
                if has_hi:
                    ehigh = f > 1.0
                    terms_k.append((jnp.where(ehigh, 1.0 - f, 0.0), "hi", 0))
                    terms_k.append((jnp.where(ehigh, f, 0.0), "hi", 1))
                edge_terms[k] = tuple(terms_k)

        # ONE dynamic-start window slice per (chunk, axis-kind combination);
        # every tap leaf is then a STATIC slice of a window: static slices
        # of one window fuse into the stencil arithmetic, where per-leaf
        # dynamic_slice ops each cost a fusion boundary. Window kinds per
        # axis: 'b' = the banded reach (block + tap span), 'lo'/'hi' = the
        # 2-row fixed edge windows.
        wcache: dict = {}

        def get_window(kinds):
            if kinds not in wcache:
                starts, sizes = [], []
                for k, kind in enumerate(kinds):
                    t_lo, t_hi = self.taps[k]
                    if kind == "b":
                        starts.append(base[k] + b_start[k])
                        sizes.append(self.block_shape[k] + t_hi + 1 - t_lo)
                    elif kind == "lo":
                        starts.append(self.pad[k][0])
                        sizes.append(2)
                    else:
                        starts.append(self.pad[k][0] + self.grid_shape[k] - 2)
                        sizes.append(2)
                wcache[kinds] = jax.lax.dynamic_slice(
                    v_pad, tuple(starts), tuple(sizes))
            return wcache[kinds]

        def leaf_slice(kinds, offsets):
            w = get_window(kinds)
            lims, sizes = [], []
            for k, (kind, off) in enumerate(zip(kinds, offsets)):
                n = self.block_shape[k] if kind == "b" else 1
                lims.append(off + n)
                sizes.append(n)
            leaf = jax.lax.slice(w, offsets, tuple(lims))
            leaf = jnp.broadcast_to(leaf, self.block_shape)
            return leaf[..., None]

        def rec(k, kinds, offsets):
            if k == d:
                return leaf_slice(kinds, offsets)
            lo_t = self.taps[k][0]
            if self.weights:
                acc = None
                for t in self.valid_taps[k]:
                    term = wstacks[k][t] * rec(
                        k + 1, kinds + ("b",), offsets + (t - lo_t,))
                    acc = term if acc is None else acc + term
            elif self.lerp_select:
                # see the ``lerp_select`` field comment: fewer ops, but
                # FMA-contraction choices make it ~1-ulp unstable across
                # program shapes — opt-in for perf paths only.
                sel_a = sel_b = None
                m_prev, t_prev = None, None
                for t in self.valid_taps[k]:
                    r_t = rec(k + 1, kinds + ("b",), offsets + (t - lo_t,))
                    m = offs[k] == t
                    term = jnp.where(m, r_t, 0.0)
                    sel_a = term if sel_a is None else sel_a + term
                    mb = m_prev if t_prev == t - 1 else (offs[k] == t - 1)
                    term = jnp.where(mb, r_t, 0.0)
                    sel_b = term if sel_b is None else sel_b + term
                    m_prev, t_prev = m, t
                if sel_a is None:       # axis fully served by edge taps
                    acc = None
                else:
                    f = fracs[k]
                    acc = (1.0 - f) * sel_a + f * sel_b
                    if inms[k] is not None:
                        acc = jnp.where(inms[k], acc, 0.0)
            else:
                # default: per-tap weights w_t = [off==t](1-f)+[off==t-1]f
                # multiplied against each tap leaf and summed in tap order.
                # Zeros add exactly and each term is its own mul->add, so
                # the result is reproducible across blocked/sharded and
                # single-chip builds (the bitwise parity contract).
                acc = None
                f = fracs[k]
                for t in self.valid_taps[k]:
                    if inms[k] is not None:
                        w_t = jnp.where(inms[k] & (offs[k] == t), 1.0 - f,
                                        0.0) \
                            + jnp.where(inms[k] & (offs[k] == t - 1), f, 0.0)
                    else:
                        w_t = jnp.where(offs[k] == t, 1.0 - f, 0.0) \
                            + jnp.where(offs[k] == t - 1, f, 0.0)
                    term = w_t * rec(k + 1, kinds + ("b",),
                                     offsets + (t - lo_t,))
                    acc = term if acc is None else acc + term
            for w, kind, idx in edge_terms[k]:
                # fixed edge window: size-1 slice, broadcast over axis k
                term = w * rec(k + 1, kinds + (kind,), offsets + (idx,))
                acc = term if acc is None else acc + term
            return acc

        total = rec(0, (), ())
        for term in costs:
            total = total + term
        for term in self.cost_static:
            total = total + term
        return jnp.broadcast_to(total, self.block_shape + (self.chunk,))

    def _rolled_interp(self, v_flat, b_start, offs, fracs, base):
        """Interpolation via nested tap scans over the FLAT table.

        ``v_flat`` is the row-major-flattened table padded by
        ``self.flat_pad``. Axis offsets compose linearly into one flat slice
        start; reads that wrap across a row boundary belong to taps whose
        weight is identically zero at those elements (taps with weight point
        at lo/lo+1, always inside the true grid), so 0 * garbage = 0.
        """
        d = len(self.grid_shape)
        L = int(np.prod(self.block_shape))
        full = self.block_shape + (self.chunk,)
        s0 = self.flat_pad[0]
        for k in range(d):
            s0 = s0 + b_start[k] * self.strides[k]

        def rec(k, flat_off):
            if k == d:
                leaf = jax.lax.dynamic_slice(v_flat, (flat_off,), (L,))
                return jnp.broadcast_to(
                    leaf.reshape(self.block_shape)[..., None], full)
            t_lo, t_hi = self.taps[k]
            # raw (unpadded) base: stored base = pad_lo + base_raw + t_lo
            base_raw = base[k] - (self.pad[k][0] + t_lo)

            def body(acc, r):
                w = jnp.where(offs[k] == r, 1.0 - fracs[k], 0.0) \
                    + jnp.where(offs[k] == r - 1, fracs[k], 0.0)
                inner = rec(k + 1,
                            flat_off + (base_raw + r) * self.strides[k])
                return acc + w * inner, None

            acc, _ = jax.lax.scan(body, jnp.zeros(full, jnp.float32),
                                  jnp.arange(t_lo, t_hi + 2))
            return acc

        return rec(0, s0)

    def __call__(self, values: jax.Array) -> BackupResult:
        if self.rolled:
            v_pad = jnp.pad(values.reshape(-1), self.flat_pad)
        else:
            v_pad = jnp.pad(values, self.pad)
        n_blocks = self.block_starts.shape[0]
        xs = (self.block_starts, self.off_res, self.frac, self.weights,
              self.cost_blocked, self.base)
        if n_blocks == 1:
            vals, args = self.block_sweep(v_pad,
                                          jax.tree.map(lambda a: a[0], xs))
        else:
            if self.unroll_blocks:
                vals, args = self._sweep_unrolled(v_pad, xs)
            else:
                vals, args = jax.lax.map(
                    lambda x: self.block_sweep(v_pad, x), xs)
            vals = self._unblock(vals)
            args = self._unblock(args)
        return BackupResult(vals, args)

    def _sweep_unrolled(self, v_pad, xs):
        """All blocks unrolled INSIDE one scan over action chunks.

        The loop nesting matters: per-block chunk scans (or a ``lax.map``
        over blocks) pay the while-loop iteration overhead once per
        (block, chunk) pair with only a small block's compute inside. Here
        one scan body does every block's tile, so overhead amortizes over
        B x the work and XLA can interleave the blocks' slices and FLOPs.
        """
        b_starts, offs, fracs, weights, costs, base = xs
        n_blocks = b_starts.shape[0]
        # (B, C, ...) -> (C, B, ...) so the chunk axis leads for the scan;
        # folds at compile time when the operator is closed over.
        swap = lambda a: jnp.swapaxes(a, 0, 1)
        cxs_all = jax.tree.map(swap, (offs, fracs, weights, costs, base))

        def chunk_step(carry, cxs):
            best_v, best_a, a_offset = carry
            new_v, new_a = [], []
            for i in range(n_blocks):
                offs_i, fracs_i, w_i, costs_i, base_i = jax.tree.map(
                    lambda a, i=i: a[i], cxs)
                total = self._chunk_total(v_pad, b_starts[i], offs_i,
                                          fracs_i, w_i, costs_i, base_i)
                m, a = self._chunk_min(total)
                a = a + a_offset
                better = m < best_v[i]  # strict: earlier chunk wins ties
                new_v.append(jnp.where(better, m, best_v[i]))
                new_a.append(jnp.where(better, a, best_a[i]))
            return (jnp.stack(new_v), jnp.stack(new_a),
                    a_offset + self.chunk), None

        init = (jnp.full((n_blocks,) + self.block_shape, jnp.inf, jnp.float32),
                jnp.zeros((n_blocks,) + self.block_shape, jnp.int32),
                jnp.asarray(0, jnp.int32))
        (vals, args, _), _ = jax.lax.scan(chunk_step, init, cxs_all)
        return vals, args

    def _unblock(self, x: jax.Array) -> jax.Array:
        """(B,) + block_shape -> state_shape, undoing _block_axes' layout."""
        d = len(self.state_shape)
        nbs = self.n_blocks_per_axis or \
            (self.block_starts.shape[0],) + (1,) * (d - 1)
        x = x.reshape(nbs + self.block_shape)
        perm = [i for k in range(d) for i in (k, d + k)]
        return jnp.transpose(x, perm).reshape(self.state_shape)


def build_stencil_backup(
    plan: InterpPlan,
    stage_cost,
    *,
    action_chunk: Optional[int] = None,
    state_blocks: int | tuple[int, ...] = 1,
    max_taps_per_axis: int = 64,
    weight_mode: str = "onthefly",
    rolled: bool = False,
    edge_split: bool = False,
    unroll_blocks: bool = False,
    lerp_select: bool = False,
) -> StencilBackup:
    """Analyze a plan's tap geometry and build the stencil operator.

    Host-side, once per problem. ``stage_cost`` may be one array or a
    sequence of broadcast-shaped terms (factorized costs never materialize
    the S x A tensor). ``state_blocks`` splits the OUTPUT grid into
    serially-swept blocks: an int blocks state axis 0 only (the halo
    engine's contract); a tuple gives blocks per state axis (each must
    divide its axis). Multi-axis blocking matters when query offsets drift
    with the state along SEVERAL axes (Kirk's x2 queries drift with both x1
    and x2): the per-(block, chunk) integer base absorbs the between-block
    drift on every blocked axis, so the residual band only covers the
    within-block spread. Raises if any axis needs more than
    ``max_taps_per_axis`` residual taps.

    ``weight_mode``: "onthefly" recomputes tap weights from (off, frac) each
    sweep (minimal memory; fastest when the operator is closed over so XLA
    constant-folds them); "precomputed" builds dense per-tap weight stacks
    on the host and ships them as inputs — use for big separable problems
    (attitude 6-D) where constant-folding would bloat the executable.

    ``rolled``: sweep taps with nested ``lax.scan`` over a flat view of the
    table instead of the unrolled shifted-slice tree — O(d x taps) HLO
    instead of O(prod taps), for high-dimensional problems whose unrolled
    tree explodes compile time/memory. Implies onthefly weights.

    ``edge_split``: serve extrapolating queries (frac outside [0,1], i.e.
    clamped past a grid edge) with FIXED edge taps so the interior band only
    covers non-extrapolating reach — a large tap-count cut for problems
    with heavy boundary extrapolation (Kirk). Unrolled + onthefly only.
    """
    if rolled and weight_mode != "onthefly":
        raise ValueError("rolled mode requires weight_mode='onthefly'")
    if edge_split and (rolled or weight_mode != "onthefly"):
        raise ValueError("edge_split requires unrolled onthefly mode")
    d = plan.ndim
    q_shape = plan.query_shape
    state_shape = q_shape[:-1]
    n_actions = q_shape[-1]
    if action_chunk is None:
        action_chunk = n_actions if n_actions <= 64 else 32
    if n_actions % action_chunk:
        raise ValueError(
            f"action axis {n_actions} not divisible by chunk {action_chunk}")
    if isinstance(state_blocks, int):
        nbs = (state_blocks,) + (1,) * (d - 1)
    else:
        nbs = tuple(int(b) for b in state_blocks)
        if len(nbs) != d:
            raise ValueError(
                f"state_blocks tuple has {len(nbs)} entries for {d} state axes")
    for k in range(d):
        if state_shape[k] % nbs[k]:
            raise ValueError(
                f"state axis {k} ({state_shape[k]}) not divisible by "
                f"state_blocks[{k}]={nbs[k]}")
    if rolled and any(nb > 1 for nb in nbs[1:]):
        raise ValueError("rolled mode slices contiguous flat blocks; only "
                         "axis-0 blocking is contiguous in the flat view")
    n_blocks = int(np.prod(nbs))
    n_chunks = n_actions // action_chunk
    block_shape = tuple(s // nb for s, nb in zip(state_shape, nbs))

    lo_np = [np.asarray(l) for l in plan.lo]
    fr_np = [np.asarray(f).astype(np.float32) for f in plan.frac]

    offs, bases, taps, pads, res_list = [], [], [], [], []
    edge_flags = []
    for k in range(d):
        lo = lo_np[k]
        # cell index of the query's own source cell along axis k
        idx_shape = [1] * lo.ndim
        idx_shape[k] = lo.shape[k]
        if lo.shape[k] == 1:
            # plan doesn't vary along its own axis k (degenerate but legal):
            # offsets are measured from cell 0
            idx = np.zeros(idx_shape, np.int64)
        else:
            idx = np.arange(lo.shape[k], dtype=np.int64).reshape(idx_shape)
        off = lo.astype(np.int64) - idx          # true tap offset per query

        # chunk the action axis, block the state axes, then absorb whatever
        # drift varies per (block, chunk) into an integer base shift — the
        # residual band (= tap count = leaf work) only has to cover the
        # WITHIN-tile spread (e.g. Kirk's a21*x1 drift of the x2 queries
        # vanishes into per-x1-block bases)
        if lo.shape[-1] > 1:
            off_c = _chunk_axis(off, n_chunks, action_chunk)  # (C, ..., chunk)
        else:
            off_c = np.broadcast_to(off[None], (n_chunks,) + off.shape)
        off_bc = _block_axes(off_c, nbs)                      # (B, C, ...)

        # edge-split: band/base statistics ignore extrapolating queries
        # (frac outside [0,1] -> lo clamped at a grid edge) — those are
        # served by fixed edge taps instead of the banded slices.
        if edge_split:
            fr = fr_np[k]
            fr_c = (np.broadcast_to(fr[None], (n_chunks,) + fr.shape)
                    if fr.shape[-1] == 1
                    else _chunk_axis(fr, n_chunks, action_chunk))
            fr_bc = _block_axes(fr_c, nbs)
            off_m, fr_m = np.broadcast_arrays(off_bc, fr_bc)
            interior = (fr_m >= 0.0) & (fr_m <= 1.0)
            edge_flags.append((bool(np.any(fr_m < 0.0)),
                               bool(np.any(fr_m > 1.0))))
            off_stat = np.where(interior, off_m, 0)
            any_int = interior.any(axis=tuple(range(2, interior.ndim))) \
                if interior.ndim > 2 else np.array(True)
        else:
            off_stat = off_bc
            interior = None
            edge_flags.append((False, False))

        if off.size > 1:
            red_axes = tuple(range(2, off_bc.ndim))
            if edge_split:
                big = np.iinfo(np.int64).max
                masked = np.where(interior, off_stat, big)
                bmin = np.where(any_int, masked.min(axis=red_axes), 0)
                masked = np.where(interior, off_stat, -big)
                bmax = np.where(any_int, masked.max(axis=red_axes), 0)
            else:
                bmin = off_bc.min(axis=red_axes)
                bmax = off_bc.max(axis=red_axes)
            base_k = ((bmin + bmax) // 2).astype(np.int64)    # (B, C)
            res = off_bc - base_k.reshape(base_k.shape + (1,) * (off_bc.ndim - 2))
        else:
            base_k = np.zeros((n_blocks, n_chunks), np.int64)
            res = off_bc

        if edge_split and interior is not None:
            res_m = np.broadcast_to(res, interior.shape)
            if interior.any():
                t_lo = int(res_m[interior].min())
                t_hi = int(res_m[interior].max())
            else:
                t_lo = t_hi = 0
            glob_min = int(min((base_k + t_lo).min(), 0))
            glob_max = int(max((base_k + t_hi).max(), 0))
        else:
            t_lo, t_hi = int(res.min()), int(res.max())
            # pad must keep every (block, chunk) window start >= 0: the
            # stored start is base_k + GLOBAL t_lo, which can undershoot
            # off_c.min() when the chunk with the smallest base is not the
            # chunk with the widest low residual — dynamic_slice would then
            # clamp and silently shift the live taps (the windows carry the
            # global band; out-of-band taps have zero weight so the extra
            # zero-pad rows read exactly 0)
            glob_min = int(min(off_c.min(), base_k.min() + t_lo))
            glob_max = int(off_c.max())
        if t_hi - t_lo + 2 > max_taps_per_axis:
            raise ValueError(
                f"axis {k}: {t_hi - t_lo + 2} taps exceed max_taps_per_axis="
                f"{max_taps_per_axis}; shrink action_chunk or use the gather backup")
        pads.append((-min(glob_min, 0), max(glob_max, 0) + 1))
        taps.append((t_lo, t_hi))
        res_list.append(res)
        offs.append(res)
        # base as slice start into the padded table: pad_lo + base
        bases.append(base_k + pads[k][0])
        # The sweep slices ONE banded window of size block + span per
        # (block, chunk) and takes static tap slices inside it. Extend the
        # high pad so the window's dynamic_slice can never clamp: a clamp
        # shifts the live taps, whereas the old per-leaf slices only ever
        # clamped on taps with zero weight. (Window end max =
        # stored_base_max + t_lo + (state - block) + block + span.)
        span = t_hi + 1 - t_lo
        stored_base_max = int(bases[-1].max()) + t_lo
        need = stored_base_max + (state_shape[k] - block_shape[k]) \
            + block_shape[k] + span
        dim = plan.grid_shape[k] + pads[k][0] + pads[k][1]
        if need > dim:
            pads[k] = (pads[k][0], pads[k][1] + need - dim)

    base = jnp.asarray(
        np.stack([b + taps[k][0] for k, b in enumerate(bases)], axis=2),
        jnp.int32)  # (B, C, d), start of tap t_lo

    fr_c, valid_taps = [], []
    for k in range(d):
        f = fr_np[k]
        if f.shape[-1] > 1:
            f_ch = _chunk_axis(f, n_chunks, action_chunk)
        else:
            f_ch = np.broadcast_to(f[None], (n_chunks,) + f.shape)
        f_ch = _block_axes(f_ch, nbs)  # (B, C, ...)
        fr_c.append(f_ch)
        # prune taps with identically-zero weight: tap t is live iff some
        # query has (off == t, weight 1-frac != 0) or (off == t-1, frac != 0)
        res, fb = np.broadcast_arrays(res_list[k], f_ch)
        if edge_split:
            # extrapolating queries are served by edge taps, so only
            # interior queries keep banded taps alive
            ok = (fb >= 0.0) & (fb <= 1.0)
        else:
            ok = np.ones_like(fb, dtype=bool)
        t_lo, t_hi = taps[k]
        live = []
        for t in range(t_lo, t_hi + 2):
            if np.any(ok & (res == t) & (1.0 - fb != 0.0)) or \
               np.any(ok & (res == t - 1) & (fb != 0.0)):
                live.append(t)
        valid_taps.append(tuple(live))

    # Stage cost: one array or factorized broadcast terms. Terms that vary
    # with the action get chunked; terms varying along state axis 0 (or the
    # action) get blocked; fully invariant terms ride along as-is.
    terms = (list(stage_cost) if isinstance(stage_cost, (tuple, list))
             else [stage_cost])
    cost_blocked, cost_static = [], []
    for term in terms:
        t = np.asarray(term, np.float32)
        if t.ndim != len(q_shape):
            t = t.reshape((1,) * (len(q_shape) - t.ndim) + t.shape)
        action_dep = t.shape[-1] > 1
        block_dep = any(nb > 1 and t.shape[k] > 1 for k, nb in enumerate(nbs))
        if not action_dep and not block_dep:
            cost_static.append(jnp.asarray(t))
            continue
        if action_dep:
            if t.shape[-1] != n_actions:
                raise ValueError(
                    f"cost term action dim {t.shape[-1]} != {n_actions}")
            t_c = _chunk_axis(t, n_chunks, action_chunk)
        else:
            t_c = np.broadcast_to(t[None], (n_chunks,) + t.shape)
        cost_blocked.append(jnp.asarray(np.ascontiguousarray(
            _block_axes(t_c, nbs))))

    off_j, fr_j, w_j = [], [], []
    if weight_mode == "precomputed":
        for k in range(d):
            res, fb = np.broadcast_arrays(res_list[k], fr_c[k])
            per_tap = []
            for t in valid_taps[k]:
                w = np.where(res == t, 1.0 - fb, 0.0) \
                    + np.where(res == t - 1, fb, 0.0)
                per_tap.append(jnp.asarray(
                    np.ascontiguousarray(w.astype(np.float32))))
            w_j.append(tuple(per_tap))
    elif weight_mode == "onthefly":
        for k in range(d):
            off_j.append(jnp.asarray(np.ascontiguousarray(offs[k]), jnp.int32))
            fr_j.append(jnp.asarray(np.ascontiguousarray(fr_c[k])))
    else:
        raise ValueError(f"unknown weight_mode {weight_mode!r}")

    # (B, d) per-axis output origin of each block, C-order block coordinates
    # (matching _block_axes' flattening of the block axes)
    coords = np.stack(np.unravel_index(np.arange(n_blocks), nbs), axis=1)
    block_starts = jnp.asarray(
        coords.astype(np.int32) * np.asarray(block_shape, np.int32))

    strides = [1] * d
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * state_shape[k + 1]
    flat_pad = (sum(pads[k][0] * strides[k] for k in range(d)),
                sum(pads[k][1] * strides[k] for k in range(d)))

    return StencilBackup(
        off_res=tuple(off_j),
        frac=tuple(fr_j),
        weights=tuple(w_j),
        base=base,
        block_starts=block_starts,
        cost_blocked=tuple(cost_blocked),
        cost_static=tuple(cost_static),
        grid_shape=plan.grid_shape,
        state_shape=state_shape,
        block_shape=block_shape,
        taps=tuple(taps),
        valid_taps=tuple(valid_taps),
        pad=tuple(pads),
        chunk=action_chunk,
        n_actions=n_actions,
        rolled=rolled,
        strides=tuple(strides),
        flat_pad=flat_pad,
        edge_taps=tuple(edge_flags) if edge_split else (),
        n_blocks_per_axis=nbs,
        unroll_blocks=unroll_blocks,
        lerp_select=lerp_select,
    )
