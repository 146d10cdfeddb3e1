"""Fused row/lane Bellman backup: one Pallas kernel through Triton.

The full-attitude solve (attitude-control/Solver_attitude.m:261-300) is the
workload the XLA stencil handles worst: its unrolled tap tree is
O(prod per-axis taps) slice leaves (~4^6 for 6-D). This kernel replaces the
whole backup — multilinear interpolation of J_{k+1} at every (state, action)
query, fused stage-cost add, fused min/argmin over the actions with MATLAB
first-minimum tie-breaking (Solver_attitude.m:384-411) — with one program
whose size is O(row taps x lane taps), independent of dimensionality.

Layout: the state grid flattens to 2-D
    rows  = the leading ``row_axes`` state axes (attitude: the omega cells),
    lanes = the remaining axes (attitude: the Euler cells),
so the value table is a (NW, NE) matrix. The problems this kernel serves
factorize over exactly this split:

* row queries depend only on (rows, action) -> each next-state row lands a
  bounded number of flat rows away, so the row-corner reads are a small
  static set of ROW shifts ``D``;
* lane queries depend only on (rows, lanes) and not on the action -> the
  lane-corner reads are a small static set of flat LANE shifts ``e``,
  shared by every action.

Each program owns one (row tile, lane block) of the output and computes,
for every live row shift D, the lane interpolation
    A_D[r, c] = sum_{lane combos e} W_e(r, c) * V[r + D, c + e]
as masked-free offset loads from a zero-padded table (the pads cover every
shift, so no load leaves the array). A_D is computed once and reused by
every action; then for each action a
    tot_a = sum_D Ww_{a,D}(r) * A_D + cost_u[a]
with per-row scalar weights, and a strict-< min/argmin chain runs in
registers over the flat C-order action index (= the reference's chained
3-axis argmin, Solver_attitude.m:400-409; equivalence proven in
ops/backup.py) — no per-action intermediate ever reaches device memory.
Reads that land on another row or lane than their own cell belong to taps
whose multilinear weight is identically zero there (a live tap keeps every
axis in range), so they contribute exactly 0.

Programs carry nothing between each other, so the grid is
``(row tiles, lane blocks)`` of independent GPU blocks. The table is read
through L2 (5.3 MB at the reference's 11^3 x 10^3 attitude grid).

The stage cost rides along factorized (SURVEY.md §7: never materialize the
S x A tensor): row-only + lane-only + action-only terms (Qw|w|^2 per row,
Qq|q_vec|^2 per lane, R|u|^2 per action for attitude,
Solver_attitude.m:315-342), plus the row x action and row x lane buckets
the stacked-channel solves need. The row+lane parts are added after the
argmin (a shared constant per state cannot change the winner).

Interpret mode is an explicit ``interpret=True`` argument (CPU tests); the
kernel never chooses it for itself, and a CPU backend refuses the compiled
kernel outright.
"""

from __future__ import annotations

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .backup import BackupResult
from .interp import InterpPlan

__all__ = ["PallasBackup6D", "PermutedRowLaneBackup", "build_pallas_backup_6d",
           "union_live_sets", "DEFAULT_ROW_TILE", "DEFAULT_LANE_BLOCK"]

# Block shape of one program: (row tile, lane block), powers of two.
DEFAULT_ROW_TILE = 8
DEFAULT_LANE_BLOCK = 64
DEFAULT_NUM_WARPS = 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _tap_weight(off, fr, t):
    """Multilinear weight of tap ``t`` for cells whose lower corner sits
    ``off`` cells away with fraction ``fr``."""
    return jnp.where(off == t, 1.0 - fr, 0.0) + jnp.where(off == t - 1, fr, 0.0)


# problems whose (rows x lanes) table exceeds this build their lane arrays
# and tap liveness on the device (see PallasBackup6D.__init__)
_DEVICE_BUILD_MIN_ELEMS = 8_000_000


def _corner_live_sets(axis_offs, axis_fracs):
    """Exact jointly-live tap combinations across a group of axes.

    A combo (t_0..t_{k-1}) is live iff some query element's multilinear
    corner reaches it with nonzero weight on EVERY axis (weight = 1-frac at
    the lo corner, frac at the hi corner). One encode pass + one
    ``np.unique`` over the elements — NOT a scan per candidate combo, which
    took ~9 minutes at the 49.8M-cell envelope (NOTES.md). Returns
    ``(per_axis_taps, combos)``; per-axis taps are those some live combo
    references (the kernel builds weight terms only for these).
    """
    k = len(axis_offs)
    base = [int(o.min()) for o in axis_offs]
    span = [int(o.max()) - b + 1 for o, b in zip(axis_offs, base)]
    bits_needed = int(np.sum(np.ceil(np.log2(np.maximum(span, 2))))) + 2 * k
    dtype = np.int32 if bits_needed < 31 else np.int64
    # in-place accumulation: these arrays are table-sized (NW x NE) — each
    # avoided temporary is hundreds of MB at the envelope scales
    enc = np.zeros(np.broadcast_shapes(*(a.shape for a in
                                         (*axis_offs, *axis_fracs))), dtype)
    for o, b, s in zip(axis_offs, base, span):
        np.multiply(enc, s, out=enc)
        enc += o
        enc -= b
    # 2 liveness bits per axis: bit0 = lo corner has weight, bit1 = hi.
    # In f32, (1-frac)==0 iff frac==1 and frac is always finite here.
    for fr in axis_fracs:
        np.left_shift(enc, 2, out=enc)
        enc |= np.not_equal(fr, np.float32(1.0))
        hi = np.not_equal(fr, np.float32(0.0)).astype(np.int8)
        np.left_shift(hi, 1, out=hi)
        enc |= hi
    return _decode_live(np.unique(enc).tolist(), base, span, k)


def _decode_live(enc_values, base, span, k):
    """Expand present encode values into the live corner-combo set."""
    combos = set()
    for e in enc_values:
        bits = [(e >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        rest = e >> (2 * k)
        offs = []
        for s in reversed(span):
            rest, o = divmod(rest, s)
            offs.append(o)
        offs = offs[::-1]
        for corner in itertools.product((0, 1), repeat=k):
            if all((b >> c) & 1 for c, b in zip(corner, bits)):
                combos.add(tuple(o + b + c for o, b, c
                                 in zip(offs, base, corner)))
    combos = sorted(combos)
    taps = [sorted({c[i] for c in combos}) for i in range(k)]
    return taps, combos


def _lane_offs_j(lane_lo, lane_iota):
    """Traced per-lane-axis offset arrays (lo - own-axis index)."""
    return [lo.astype(jnp.int32)[..., 0] - it
            for lo, it in zip(lane_lo, lane_iota)]


def _lane_live_device(lane_lo, lane_fr, lane_iota):
    """Device-side twin of :func:`_corner_live_sets` for the lane group:
    the encode runs as one jitted dispatch and only a bincount (a few KB)
    comes back to the host for decoding."""
    k = len(lane_lo)

    def minmax(los):
        o = _lane_offs_j(los, lane_iota)
        return (jnp.stack([x.min() for x in o]),
                jnp.stack([x.max() for x in o]))

    mins, maxs = jax.jit(minmax)(tuple(lane_lo))
    base = [int(v) for v in np.asarray(mins)]
    span = [int(hi) - b + 1 for hi, b in zip(np.asarray(maxs), base)]
    bits = int(np.sum(np.ceil(np.log2(np.maximum(span, 2))))) + 2 * k
    nbins = int(np.prod(span)) << (2 * k)
    if bits >= 31 or nbins > (1 << 24):
        raise ValueError(
            f"lane tap encode needs {bits} bits / {nbins} bins — offsets "
            "reach too far for the row/lane kernel; use the stencil backup")

    def count(los, frs):
        o = _lane_offs_j(los, lane_iota)
        enc = None
        for x, b, s in zip(o, base, span):
            t = x - b
            enc = t if enc is None else enc * s + t
        for fr in frs:
            f0 = fr.astype(jnp.float32)[..., 0]
            bv = (f0 != 1.0).astype(jnp.int32) \
                | ((f0 != 0.0).astype(jnp.int32) << 1)
            enc = (enc << 2) | bv
        return jnp.bincount(enc.reshape(-1), length=nbins)

    n_rows = max(a.shape[0] for a in lane_lo)
    n_elems = n_rows * max(a.shape[1] for a in lane_lo)
    # row-chunking requires every array DENSE over rows in the flat layout;
    # broadcast (1, NE, 1) axes (row-independent lane queries) can't be
    # row-sliced — those keep the one-shot encode
    chunkable = all(a.ndim == 3 and a.shape[0] == n_rows
                    for a in (*lane_lo, *lane_fr))
    if n_elems <= 200_000_000 or not chunkable:
        counts = jax.jit(count)(tuple(lane_lo), tuple(lane_fr))
    else:
        # past ~200M elements the one-shot encode's int32 transients are
        # GBs — accumulate the bincount over row blocks instead (the
        # last block overlaps backward; double-counting cannot change
        # which bins are NONZERO, the only thing decoded)
        B = max(1, 100_000_000 // max(a.shape[1] for a in lane_lo))

        def count_block(los, frs, r0):
            sl = tuple(jax.lax.dynamic_slice_in_dim(a, r0, B, 0)
                       for a in los)
            sf = tuple(jax.lax.dynamic_slice_in_dim(a, r0, B, 0)
                       for a in frs)
            return count(sl, sf)

        fn = jax.jit(count_block)
        r0s = list(range(0, n_rows - B + 1, B))
        if r0s[-1] + B < n_rows:
            r0s.append(n_rows - B)
        counts = None
        for r0 in r0s:
            c = fn(tuple(lane_lo), tuple(lane_fr), jnp.asarray(r0, jnp.int32))
            counts = c if counts is None else counts + c
    vals = np.nonzero(np.asarray(counts))[0].tolist()
    return _decode_live(vals, base, span, k)


def _lane_arrays_device(lane_lo, lane_fr, lane_iota, full_shape,
                        NW, NE, NWp, NEp, consume=False):
    """Device-side twin of the host ``lane_full`` fill: padded (NWp, NEp)
    off/frac arrays built per AXIS in jitted dispatches, same pad semantics
    (lane pads duplicate lane 0, row pads duplicate the edge row).
    ``full_shape`` is the pre-flatten broadcast target — the grid's state
    shape for full plans, ``(NW, NE)`` for flat ones.

    ``consume=True`` explicitly ``.delete()``s each plan axis's lo/frac
    buffers right after its padded copies are built, so peak device memory
    is the plan + ONE axis's copies instead of plan + ALL copies.
    (Donation cannot do this: XLA input-output aliasing
    requires exactly matching shapes and the padded outputs never match —
    tried, discarded with a warning.) The caller's plan arrays are INVALID
    afterwards — opt in only when the plan is about to be dropped
    (solve_full's flat path swaps in a PlanShape immediately)."""

    def pad2(a):
        if NEp > NE:
            a = jnp.concatenate(
                [a, jnp.broadcast_to(a[:, :1], (NW, NEp - NE))], 1)
        if NWp > NW:
            a = jnp.concatenate(
                [a, jnp.broadcast_to(a[-1:], (NWp - NW, NEp))], 0)
        return a

    def build_one(lo, fr, iota):
        off = _lane_offs_j([lo], [iota])[0]
        off2 = jnp.broadcast_to(off, full_shape).reshape(NW, NE)
        fr2 = jnp.broadcast_to(fr.astype(jnp.float32)[..., 0],
                               full_shape).reshape(NW, NE)
        return pad2(off2), pad2(fr2)

    fn = jax.jit(build_one)
    offs_out, frs_out = [], []
    for lo, fr, iota in zip(lane_lo, lane_fr, lane_iota):
        o, f = fn(lo, fr, iota)
        if consume:
            jax.block_until_ready((o, f))
            lo.delete()
            fr.delete()
        offs_out.append(o)
        frs_out.append(f)
    return tuple(offs_out), tuple(frs_out)


@jax.tree_util.register_pytree_node_class
class PallasBackup6D:
    """Callable fused backup for row/lane-separable problems.

    ``row_axes`` state axes (default 3) form the flat row index; queries
    along them must not vary with the lane axes. The remaining state axes
    form the flat lane index; queries along them must not vary with the
    action. The attitude ``build_full`` plan satisfies both by construction.

    ``row_tile`` x ``lane_block`` is one program's output block (powers of
    two), run by DEFAULT_NUM_WARPS Triton warps. ``interpret=True`` runs
    the kernel in the Pallas interpreter (CPU tests only).
    """

    def __init__(self, plan: InterpPlan, cost_terms, *, row_axes: int = 3,
                 row_tile: int | None = None, lane_block: int | None = None,
                 interpret: bool = False,
                 max_flat_taps: int = 40, row_pad_to: int | None = None,
                 consume_plan: bool = False, argmin_dtype=jnp.int32,
                 device_build: bool | None = None,
                 live_sets: tuple | None = None,
                 cost_act_traced: bool = False,
                 carry_padded: bool = False,
                 digit_slice: int | None = None,
                 analyze_only: bool = False,
                 track_argmin: bool = True):
        d = plan.ndim
        q_shape = plan.query_shape
        # track_argmin=False: min-only sweeps — the argmin select chain
        # drops out of the kernel (the argmin output is zeros). Correct
        # whenever the caller keeps only the LAST sweep's argmin: run
        # sweeps 0..n-2 min-only and the final sweep with a tracking kernel.
        self.track_argmin = bool(track_argmin)
        self.argmin_dtype = np.dtype(argmin_dtype)
        if np.issubdtype(self.argmin_dtype, np.integer) and \
                np.iinfo(self.argmin_dtype).max < q_shape[-1] - 1:
            raise ValueError(
                f"argmin_dtype {self.argmin_dtype} cannot index "
                f"{q_shape[-1]} actions")
        # FLAT plans carry their per-axis lo/frac in (rows, lanes, actions)
        # layout — (NW, 1, A) for row axes, (NW, NE, 1) for lane axes — so
        # no array ever exists in the d-dimensional broadcast shape (how
        # big plans are built on the device).
        self.flat = len(q_shape) != d + 1
        if self.flat and len(q_shape) != 3:
            raise ValueError("flat plans must have (rows, lanes, A) arrays")
        state_shape = plan.grid_shape if self.flat else q_shape[:-1]
        if len(state_shape) != d:
            raise ValueError("plan query shape mismatch")
        self.state_shape = state_shape
        self.n_actions = q_shape[-1]
        nr, nc = row_axes, d - row_axes
        self.NW = int(np.prod(state_shape[:nr]))
        self.NE = int(np.prod(state_shape[nr:]))
        if self.flat and (q_shape[0] != self.NW or q_shape[1] != self.NE):
            raise ValueError(
                f"flat plan rows/lanes {q_shape[:2]} do not match the "
                f"row_axes={row_axes} split of grid {state_shape}")
        self.row_tile = row_tile or DEFAULT_ROW_TILE
        self.lane_block = lane_block or DEFAULT_LANE_BLOCK
        if not (_is_pow2(self.row_tile) and _is_pow2(self.lane_block)):
            raise ValueError(
                f"row_tile={self.row_tile} and lane_block={self.lane_block} "
                "must be powers of two")
        self.NEp = _round_up(self.NE, self.lane_block)
        self.interpret = bool(interpret)
        # Big problems build lane arrays + tap liveness ON DEVICE as jitted
        # dispatches: the host path pays several full passes per
        # table-sized numpy array. Plan arrays are passed as jit ARGUMENTS,
        # never closures (table-sized compile-time constants).
        # device_build is overridable so tests reach that path at small
        # sizes.
        if device_build is None:
            device_build = (not self.interpret
                            and self.NW * self.NE > _DEVICE_BUILD_MIN_ELEMS)
        self._device_build = device_build

        # --- tap analysis -------------------------------------------------
        row_strides = [int(np.prod(state_shape[k + 1:nr], dtype=np.int64))
                       for k in range(nr)]
        lane_strides = [int(np.prod(state_shape[k + 1:], dtype=np.int64))
                        for k in range(nr, d)]

        w_off, w_frac = [], []
        for k in range(nr):
            lo = np.asarray(plan.lo[k])
            fr = np.asarray(plan.frac[k], np.float32)
            lane_dims = lo.shape[1:2] if self.flat else lo.shape[nr:d]
            lane_dims_f = fr.shape[1:2] if self.flat else fr.shape[nr:d]
            if any(s > 1 for s in lane_dims) or \
               any(s > 1 for s in lane_dims_f):
                raise ValueError(
                    f"row axis {k} query varies along lane axes — "
                    "not row/lane separable; use the stencil/gather backup")
            if self.flat:
                idx = ((np.arange(self.NW, dtype=np.int32)
                        // row_strides[k]) % state_shape[k])[:, None]
                off = lo[:, 0, :].astype(np.int32) - idx
                fr2 = fr[:, 0, :]
            else:
                idx = np.arange(state_shape[k], dtype=np.int32).reshape(
                    (1,) * k + (-1,) + (1,) * (d - k))
                off = np.broadcast_to(
                    lo.astype(np.int32) - idx,
                    state_shape[:nr] + (1,) * nc + (self.n_actions,)
                ).reshape(self.NW, self.n_actions)
                fr2 = np.broadcast_to(
                    fr, state_shape[:nr] + (1,) * nc + (self.n_actions,)
                ).reshape(self.NW, self.n_actions)
            w_off.append(np.broadcast_to(off,
                                         (self.NW, self.n_actions)))
            w_frac.append(np.broadcast_to(fr2,
                                          (self.NW, self.n_actions)))

        # lane off/frac stay BROADCAST VIEWS here: the padded arrays below
        # are filled in ONE pass each. Per-axis lane iotas: own-axis grid
        # index as a function of the flat lane position (flat plans) or a
        # broadcast arange (full plans).
        e_off, e_frac = [], []
        lane_lo, lane_fr, lane_iota = [], [], []
        for k in range(nr, d):
            lo_d, fr_d = plan.lo[k], plan.frac[k]
            if lo_d.shape[-1] > 1 or fr_d.shape[-1] > 1:
                raise ValueError(
                    f"lane axis {k} query varies with the action — "
                    "not row/lane separable; use the stencil/gather backup")
            if self.flat:
                iota = ((np.arange(self.NE, dtype=np.int32)
                         // lane_strides[k - nr]) % state_shape[k])[None, :]
            else:
                iota = np.arange(state_shape[k], dtype=np.int32).reshape(
                    (1,) * k + (-1,) + (1,) * (d - 1 - k))
            if self._device_build:
                lane_lo.append(lo_d)
                lane_fr.append(fr_d)
                lane_iota.append(jnp.asarray(iota))
                continue
            lo = np.asarray(lo_d)
            fr = np.asarray(fr_d, np.float32)
            e_off.append(lo.astype(np.int32, copy=False)[..., 0] - iota)
            e_frac.append(fr[..., 0])

        w_taps, row_combos = _corner_live_sets(w_off, w_frac)
        if self._device_build:
            e_taps, lane_combos = _lane_live_device(lane_lo, lane_fr,
                                                    lane_iota)
        else:
            e_taps, lane_combos = _corner_live_sets(e_off, e_frac)
        if live_sets is not None:
            # SUPERSET tap structure shared across several problems so each
            # one's backup has an IDENTICAL treedef — the stacked-channel EP
            # solve (models/pos_att.solve_ep) shard_maps ONE traced program
            # over per-channel leaf stacks, which requires static aux
            # equality. Taps/combos a given problem never reaches carry
            # exactly-zero weights at every (row, lane, action) element, so
            # values and argmin are unchanged (0-contribution addends).
            # Validated as a superset so a stale union fails loudly.
            u_w_taps, u_row_combos, u_e_taps, u_lane_combos = live_sets
            for k in range(nr):
                if not set(w_taps[k]) <= set(u_w_taps[k]):
                    raise ValueError(
                        f"live_sets row taps axis {k} {u_w_taps[k]} do not "
                        f"cover this plan's {tuple(w_taps[k])}")
            if not {tuple(c) for c in row_combos} <= \
                    {tuple(c) for c in u_row_combos}:
                raise ValueError("live_sets row combos do not cover this "
                                 "plan's live combos")
            for k in range(d - nr):
                if not set(e_taps[k]) <= set(u_e_taps[k]):
                    raise ValueError(
                        f"live_sets lane taps axis {k} {u_e_taps[k]} do not "
                        f"cover this plan's {tuple(e_taps[k])}")
            if not {tuple(c) for c in lane_combos} <= \
                    {tuple(c) for c in u_lane_combos}:
                raise ValueError("live_sets lane combos do not cover this "
                                 "plan's live combos")
            w_taps, row_combos = u_w_taps, u_row_combos
            e_taps, lane_combos = u_e_taps, u_lane_combos
        self.row_combos = tuple(row_combos)    # flat row offs
        self.lane_combos = tuple(lane_combos)  # flat lane offs
        self.w_taps = tuple(tuple(t) for t in w_taps)
        self.e_taps = tuple(tuple(t) for t in e_taps)
        if analyze_only:
            # tap-analysis pass only (union_live_sets input): stop before
            # any padded device array is built. The resulting object is
            # NOT callable — it exists to donate its tap/combo structure
            # to a union rebuild (models/pos_att.build_ep_rowlane_backups).
            return

        # Action-digit factorization: when row axis k's (off, frac) depend
        # only on digit k of the C-order action index (true for attitude —
        # u_k enters only axis k's dynamics), the action phase contracts
        # tap axes one digit at a time: 3*digits^(axes) FMAs instead of
        # actions * row_combos (243 vs 729 at 27 actions).
        self.action_digits = None
        self.digit_slice = None
        if digit_slice is not None:
            # This kernel computes ONE fixed-d0 digit slice of a digit-
            # factorized action set (A_full = m^3, this slice = m^2 actions
            # with digits (d0, *, *)) — the action-sharded halo6 engine's
            # per-group kernel. The factorized contraction's B/C partials
            # depend only on digits 1..2, so running it here (local d0 = 0
            # maps to column 0 — correct: axis-0 columns are all equal
            # within a slice) reproduces the full kernel's per-action
            # rounding bitwise.
            if nr != 3:
                raise ValueError("digit_slice requires 3 row axes")
            m = int(digit_slice)
            if self.n_actions != m * m:
                raise ValueError(
                    f"digit_slice m={m} does not match "
                    f"{self.n_actions} actions")
            for arrs in (w_off, w_frac):
                if not np.all(np.asarray(arrs[0])
                              == np.asarray(arrs[0])[:, :1]):
                    raise ValueError(
                        "digit_slice: axis-0 queries vary within the slice "
                        "(digit 0 is supposed to be fixed)")
            if self._detect_action_digits(w_off[1:], w_frac[1:], 2) != m:
                raise ValueError(
                    "digit_slice: axes 1-2 are not digit-factorized")
            self.action_digits = m
            self.digit_slice = m
        elif nr == 3 and live_sets is None:
            # (under live_sets the digit decision could differ per problem
            # — e.g. edge-padded action columns break it — so EP-stacked
            # backups uniformly use the generic action phase)
            self.action_digits = self._detect_action_digits(w_off, w_frac,
                                                            nr)
        if len(self.row_combos) > max_flat_taps or \
           len(self.lane_combos) > max_flat_taps:
            raise ValueError(
                f"{len(self.row_combos)} row x {len(self.lane_combos)} lane "
                f"flat taps exceed max_flat_taps={max_flat_taps}")
        self.row_deltas = tuple(sum(t * s for t, s in zip(c, row_strides))
                                for c in self.row_combos)
        self.lane_deltas = tuple(sum(t * s for t, s in zip(c, lane_strides))
                                 for c in self.lane_combos)
        self.d_min = min(self.row_deltas)
        self.d_max = max(self.row_deltas)

        # --- padded device-side inputs ----------------------------------
        T, BL = self.row_tile, self.lane_block
        self.NWp = _round_up(self.NW, T)
        if row_pad_to is not None:
            # row-sharded engines pad further so NWp divides evenly into
            # per-device blocks of whole tiles (parallel/halo6.py)
            if row_pad_to < self.NWp or row_pad_to % T:
                raise ValueError(
                    f"row_pad_to={row_pad_to} must be a multiple of "
                    f"row_tile={T} and >= {self.NWp}")
            self.NWp = row_pad_to

        def pad_rows(a, fill_edge=True):
            if a.shape[0] == self.NWp:
                return a
            pad = self.NWp - a.shape[0]
            mode = "edge" if fill_edge else "constant"
            return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), mode=mode)

        def pad_lanes(a):
            if a.shape[1] == self.NEp:
                return a
            # duplicate lane 0 so pad-lane arithmetic stays finite
            pad = a[:, :1].repeat(self.NEp - a.shape[1], axis=1)
            return np.concatenate([a, pad], axis=1)

        def lane_full(src, dtype):
            """(NWp, NEp) array filled from a state-shaped broadcast view:
            at most one contiguous materialization + one 2-D strided copy
            (numpy's d-D fancy assignment paths are ~10x slower)."""
            out = np.empty((self.NWp, self.NEp), dtype)
            if self.flat:
                src2 = np.broadcast_to(src, (self.NW, self.NE))
            else:
                src2 = np.broadcast_to(src, state_shape).reshape(
                    self.NW, self.NE)
            out[:self.NW, :self.NE] = src2
            if self.NE < self.NEp:       # dup lane 0: finite arithmetic
                out[:self.NW, self.NE:] = out[:self.NW, :1]
            if self.NW < self.NWp:       # edge rows
                out[self.NW:] = out[self.NW - 1]
            return out

        self.w_off_j = tuple(jnp.asarray(pad_rows(o).astype(np.int32))
                             for o in w_off)
        self.w_frac_j = tuple(jnp.asarray(pad_rows(f)) for f in w_frac)
        if self._device_build:
            self.e_off_j, self.e_frac_j = _lane_arrays_device(
                lane_lo, lane_fr, lane_iota,
                (self.NW, self.NE) if self.flat else state_shape,
                self.NW, self.NE, self.NWp, self.NEp,
                consume=consume_plan)
            if consume_plan:
                # the caller's plan lane buffers are DELETED now; nothing
                # below this point may touch `plan` — enforced structurally
                plan = None  # noqa: F841
        else:
            self.e_off_j = tuple(jnp.asarray(lane_full(o, np.int32))
                                 for o in e_off)
            self.e_frac_j = tuple(jnp.asarray(lane_full(f, np.float32))
                                  for f in e_frac)

        # --- factorized stage cost --------------------------------------
        # Terms factor into: row-only, lane-only, action-only (the 6-D
        # attitude split), plus two COUPLED buckets the stacked-channel EP
        # problem needs (models/pos_att.py solve_ep): row x action (per-
        # channel action costs incl. +inf padding of short action sets —
        # affects the argmin, contracted in the action phase) and
        # row x lane (per-channel lane state costs — argmin-neutral, added
        # after it like c_row/c_lane). lane x action coupling stays
        # unsupported (would force a table-sized per-action weight).
        c_row = np.zeros(self.NW, np.float32)
        c_lane = np.zeros(self.NE, np.float32)
        c_act = np.zeros(self.n_actions, np.float32)
        c_rowact = None
        c_rowlane = None
        terms = (list(cost_terms) if isinstance(cost_terms, (tuple, list))
                 else [cost_terms])
        nd_t = 3 if self.flat else d + 1
        for term in terms:
            t = np.asarray(term, np.float32)
            if t.ndim != nd_t:
                t = t.reshape((1,) * (nd_t - t.ndim) + t.shape)
            if self.flat:
                row_dep, lane_dep = t.shape[0] > 1, t.shape[1] > 1
            else:
                row_dep = any(s > 1 for s in t.shape[:nr])
                lane_dep = any(s > 1 for s in t.shape[nr:d])
            act_dep = t.shape[-1] > 1
            if lane_dep and act_dep:
                raise ValueError(
                    "cost term couples the lane and action groups — "
                    "not factorizable for the row/lane kernel")
            if act_dep and (row_dep or cost_act_traced):
                # cost_act_traced: per-action costs ride the TRACED
                # row x action bucket instead of the static c_act
                # immediates, so problems with different action costs
                # (e.g. +inf-padded short action sets) share one treedef
                shape = (self.NW, 1, self.n_actions) if self.flat \
                    else state_shape[:nr] + (1,) * nc + (self.n_actions,)
                add = np.broadcast_to(t, shape).reshape(self.NW,
                                                        self.n_actions)
                c_rowact = add.copy() if c_rowact is None else c_rowact + add
            elif row_dep and lane_dep:
                add = lane_full(t[..., 0], np.float32)
                c_rowlane = add if c_rowlane is None else c_rowlane + add
            elif act_dep:
                c_act += t.reshape(-1) if self.flat else np.broadcast_to(
                    t, (1,) * d + (self.n_actions,)).reshape(self.n_actions)
            elif lane_dep:
                shape = (1, self.NE, 1) if self.flat \
                    else (1,) * nr + state_shape[nr:] + (1,)
                c_lane += np.broadcast_to(t, shape).reshape(self.NE)
            else:
                shape = (self.NW, 1, 1) if self.flat \
                    else state_shape[:nr] + (1,) * (nc + 1)
                c_row += np.broadcast_to(t, shape).reshape(self.NW)
        self.c_row_j = jnp.asarray(pad_rows(c_row[:, None]))
        self.c_lane_j = jnp.asarray(pad_lanes(c_lane[None, :]))
        self.c_rowact_j = () if c_rowact is None \
            else (jnp.asarray(pad_rows(c_rowact)),)
        self.c_rowlane_j = () if c_rowlane is None \
            else (jnp.asarray(c_rowlane),)
        # per-action scalars become kernel immediates (tiny, host-known)
        self.c_act = tuple(float(x) for x in c_act)

        # --- padded table layout ----------------------------------------
        # Table = [pad_top rows; NWp rows; pad_bot rows] x [lane_pad lanes;
        # NEp lanes; right pad], zeros outside the real (NW, NE) block.
        # Output row r / lane c reads table row pad_top + r + D and lane
        # lane_pad + c + e: the pads cover every shift, so no load needs a
        # mask. lane_pad and the table width are whole lane blocks so the
        # padded-carry mode can write the table itself block by block.
        self.carry_padded = bool(carry_padded)
        self.lane_pad = _round_up(max(-min(self.lane_deltas), 0), BL)
        self.table_width = _round_up(
            self.lane_pad + self.NEp + max(max(self.lane_deltas), 0), BL)
        self.pad_top = max(-self.d_min, 0)
        self.pad_bot = max(self.d_max, 0)
        if self.carry_padded:
            # Padded-carry mode: the engine's scan carry IS the padded
            # table and the kernel writes the NEXT padded table directly —
            # no per-sweep pad/slice copies. Pads round up to whole tiles
            # so every output block is purely real or purely pad; pad
            # blocks, rows past NW and lanes past NE are written as zeros,
            # so the carry's pads stay zero sweep after sweep.
            self.pad_top = _round_up(self.pad_top, T)
            self.pad_bot = _round_up(self.pad_bot, T)

    @staticmethod
    def _detect_action_digits(w_off, w_frac, nr):
        """Detect a C-order digit decomposition A = m^nr where row axis k's
        (off, frac) columns depend only on digit k. Returns m or None."""
        A = w_off[0].shape[1]
        m = round(A ** (1.0 / nr))
        if m**nr != A or m < 2:
            return None
        for k in range(nr):
            stride = m ** (nr - 1 - k)
            for a in range(A):
                rep = (a // stride) % m * stride  # canonical column per digit
                if not (np.array_equal(w_off[k][:, a], w_off[k][:, rep])
                        and np.array_equal(w_frac[k][:, a],
                                           w_frac[k][:, rep])):
                    return None
        return m

    # ------------------------------------------------------------- kernel
    def _kernel(self, carry, v_ref, *refs):
        nr, nc = len(self.w_off_j), len(self.e_off_j)
        it = iter(refs)
        w_off = [next(it) for _ in range(nr)]
        w_frac = [next(it) for _ in range(nr)]
        e_off = [next(it) for _ in range(nc)]
        e_frac = [next(it) for _ in range(nc)]
        c_row = next(it)
        c_ra = next(it) if self.c_rowact_j else None
        c_rl = next(it) if self.c_rowlane_j else None
        c_lane = next(it)
        lane_meta = next(it)
        out_v, out_a = next(it), next(it)

        T, BL = self.row_tile, self.lane_block
        i, j = pl.program_id(0), pl.program_id(1)
        if carry:
            # the output block IS a table block: table coordinates equal
            # output coordinates, argument coordinates drop the pads
            tr0, tc0 = i * T, j * BL
            ar0, ac0 = tr0 - self.pad_top, tc0 - self.lane_pad
        else:
            ar0, ac0 = i * T, j * BL
            tr0, tc0 = ar0 + self.pad_top, ac0 + self.lane_pad
        rows, lanes = pl.ds(ar0, T), pl.ds(ac0, BL)

        def compute():
            # A_D = lane interpolation of the table shifted by row delta D,
            # accumulated over the joint lane combos (the lane fracs may
            # couple across lane axes — the attitude Euler queries do).
            # A runtime loop over combos keeps the program small; each
            # combo's taps and flat lane delta come from ``lane_meta``.
            offs = [e_off[k][rows, lanes] for k in range(nc)]
            frs = [e_frac[k][rows, lanes] for k in range(nc)]

            def lane_combo(n, acc):
                w = None
                for k in range(nc):
                    wk = _tap_weight(offs[k], frs[k], lane_meta[n, k])
                    w = wk if w is None else w * wk
                shifted = pl.ds(tc0 + lane_meta[n, nc], BL)
                out = []
                for a, dr in zip(acc, self.row_deltas):
                    x = v_ref[pl.ds(tr0 + dr, T), shifted]
                    out.append(a + (x if w is None else w * x))
                return tuple(out)

            acc = jax.lax.fori_loop(
                0, len(self.lane_combos), lane_combo,
                tuple(jnp.zeros((T, BL), jnp.float32)
                      for _ in self.row_deltas))

            # per-row tap weight columns (T, 1), loaded per (axis, action)
            loaded = {}

            def wcol(k, t, a):
                if (k, a) not in loaded:
                    loaded[(k, a)] = (w_off[k][rows, pl.ds(a, 1)],
                                      w_frac[k][rows, pl.ds(a, 1)])
                return _tap_weight(*loaded[(k, a)], t)

            if self.action_digits and nr == 3:
                totals = self._action_totals_factorized(wcol, acc)
            else:
                totals = self._action_totals_generic(wcol, acc)
            best_v = best_a = None
            for a, tot in enumerate(totals):
                if self.c_act[a]:
                    tot = tot + self.c_act[a]
                if c_ra is not None:
                    tot = tot + c_ra[rows, pl.ds(a, 1)]   # row x action
                if best_v is None:
                    best_v = tot
                    best_a = jnp.zeros((T, BL), jnp.int32)
                elif not self.track_argmin:
                    # the same where-min (jnp.minimum would propagate NaN
                    # where the reference's min ignores it, ops/backup.py)
                    best_v = jnp.where(tot < best_v, tot, best_v)
                else:
                    better = tot < best_v        # strict: first minimum wins
                    best_v = jnp.where(better, tot, best_v)
                    best_a = jnp.where(better, jnp.int32(a), best_a)
            vals = best_v + c_row[rows, pl.ds(0, 1)] \
                + c_lane[pl.ds(0, 1), lanes]
            if c_rl is not None:
                vals = vals + c_rl[rows, lanes]
            # rows past NW / lanes past NE hold edge-duplicated-arg
            # garbage; in carry mode they persist sweep to sweep and
            # extrapolation weights can be expansive (|1-f|+|f| > 1), so
            # unzeroed garbage could compound to inf and poison real cells
            # through 0-weight taps (0 * inf = NaN). Zeroed in both modes
            # so both compile alike (bitwise-equal results).
            r_i = ar0 + jax.lax.broadcasted_iota(jnp.int32, (T, BL), 0)
            c_i = ac0 + jax.lax.broadcasted_iota(jnp.int32, (T, BL), 1)
            real = (r_i < self.NW) & (c_i < self.NE)
            vals = jnp.where(real, vals, 0.0)
            best_a = jnp.where(real, best_a, 0)
            out_v[...] = vals
            out_a[...] = best_a.astype(self.argmin_dtype)

        # blocks are purely real or purely pad (padded-carry mode has pad
        # blocks); pad blocks only zero their outputs — they never read
        # the arguments. Both modes branch the same way, so their compute
        # compiles alike (bitwise-equal results).
        is_real = ((ar0 >= 0) & (ar0 < self.NWp)
                   & (ac0 >= 0) & (ac0 < self.NEp))
        pl.when(is_real)(compute)

        @pl.when(jnp.logical_not(is_real))
        def _zero_pad_block():
            out_v[...] = jnp.zeros((T, BL), jnp.float32)
            out_a[...] = jnp.zeros((T, BL), self.argmin_dtype)

    def _action_totals_generic(self, wcol, acc):
        """Per-action interpolated totals, actions x |row_combos| FMAs
        (any action structure)."""
        totals = []
        for a in range(self.n_actions):
            tot = None
            for jd, combo in enumerate(self.row_combos):
                w = None
                for k, t in enumerate(combo):
                    col = wcol(k, t, a)
                    w = col if w is None else w * col
                term = w * acc[jd]
                tot = term if tot is None else tot + term
            totals.append(tot)
        return totals

    def _action_totals_factorized(self, wcol, acc):
        """Digit-factorized contraction: axis k's weight depends only on
        action digit k (C-order a = (a0*m + a1)*m + a2), so tap axes
        contract one digit at a time — ~3*m^3 FMAs instead of
        A * |row_combos| (243 vs 729 for the attitude 27-action set)."""
        m = self.action_digits
        jidx = {c: jd for jd, c in enumerate(self.row_combos)}
        t0s = sorted({c[0] for c in self.row_combos})
        t01s = sorted({c[:2] for c in self.row_combos})

        def col(k, t, digit):
            return wcol(k, t, digit * m ** (2 - k))   # canonical action

        part_b = {}
        for (t0, t1) in t01s:
            for d2 in range(m):
                s = None
                for t2 in self.w_taps[2]:
                    jd = jidx.get((t0, t1, t2))
                    if jd is None:
                        continue
                    term = col(2, t2, d2) * acc[jd]
                    s = term if s is None else s + term
                part_b[(t0, t1, d2)] = s
        part_c = {}
        for t0 in t0s:
            for d1 in range(m):
                for d2 in range(m):
                    s = None
                    for t1 in self.w_taps[1]:
                        b = part_b.get((t0, t1, d2))
                        if b is None:
                            continue
                        term = col(1, t1, d1) * b
                        s = term if s is None else s + term
                    part_c[(t0, d1, d2)] = s
        totals = []
        for a in range(self.n_actions):
            d0, rem = divmod(a, m * m)
            d1, d2 = divmod(rem, m)
            tot = None
            for t0 in t0s:
                c = part_c.get((t0, d1, d2))
                if c is None:
                    continue
                term = col(0, t0, d0) * c
                tot = term if tot is None else tot + term
            totals.append(tot)
        return totals

    # pytree protocol: arrays are leaves so the whole backup can ride
    # through jit/scan as an ARGUMENT — its off/frac tables must never
    # become compile-time constants.
    traced_argument = True   # engines must pass this backup as a jit ARG

    _LEAF_FIELDS = ("w_off_j", "w_frac_j", "e_off_j", "e_frac_j",
                    "c_row_j", "c_rowact_j", "c_rowlane_j", "c_lane_j")
    _AUX_FIELDS = ("state_shape", "n_actions", "NW", "NE", "NEp", "NWp",
                   "row_tile", "lane_block", "interpret",
                   "row_combos", "lane_combos", "row_deltas", "lane_deltas",
                   "d_min", "d_max", "w_taps", "e_taps", "c_act",
                   "pad_top", "pad_bot", "lane_pad", "table_width",
                   "action_digits", "argmin_dtype", "carry_padded",
                   "digit_slice", "track_argmin")

    def tree_flatten(self):
        return (tuple(getattr(self, f) for f in self._LEAF_FIELDS),
                tuple(getattr(self, f) for f in self._AUX_FIELDS))

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        for f, v in zip(cls._AUX_FIELDS, aux):
            setattr(obj, f, v)
        for f, v in zip(cls._LEAF_FIELDS, leaves):
            setattr(obj, f, v)
        return obj

    @property
    def sweep_args(self) -> tuple:
        """Device arrays in ``_sweep_padded`` order: the leading
        ``len(sweep_args) - n_replicated_args`` are PER-ROW (sharded
        engines pass device-local row slices of exactly these); the
        trailing ``n_replicated_args`` are per-lane/replicated."""
        return (*self.w_off_j, *self.w_frac_j, *self.e_off_j,
                *self.e_frac_j, self.c_row_j, *self.c_rowact_j,
                *self.c_rowlane_j, self.c_lane_j)

    @property
    def n_replicated_args(self) -> int:
        """Trailing :attr:`sweep_args` entries that are NOT per-row arrays
        (c_lane) — sharded engines replicate these."""
        return 1

    def _sweep_padded(self, v2p: jax.Array, args, nwp: int,
                      carry: bool = False):
        """One backup sweep over ``nwp`` (padded) output rows.

        ``v2p`` is the (pad_top + nwp + pad_bot, NEp or table_width)
        padded value window (NEp-wide windows gain their lane pads here);
        ``args`` are (local slices of) :attr:`sweep_args` with ``nwp``
        rows each (``c_lane`` excepted). Returns ``(vals, argm)`` of shape
        (nwp, NEp) — callers slice/reshape.

        ``carry``: padded-carry mode — ``v2p`` is the full
        :attr:`carry_shape` table and the output IS the next sweep's table
        (pad blocks emit zeros).
        """
        T, BL = self.row_tile, self.lane_block
        if v2p.shape[1] != self.table_width:
            v2p = jnp.pad(v2p, ((0, 0), (self.lane_pad, self.table_width
                                          - self.lane_pad - v2p.shape[1])))
        if carry:
            nwp, width = self.carry_rows, self.table_width
        else:
            width = self.NEp
        # per lane combo: its taps on each lane axis + its flat lane delta
        lane_meta = jnp.asarray(
            [(*c, dl) for c, dl in zip(self.lane_combos, self.lane_deltas)],
            jnp.int32)
        block = pl.BlockSpec((T, BL), lambda i, j: (i, j))
        return pl.pallas_call(
            functools.partial(self._kernel, carry),
            grid=(nwp // T, width // BL),
            in_specs=[pl.no_block_spec] * (2 + len(args)),
            out_specs=[block, block],
            out_shape=[
                jax.ShapeDtypeStruct((nwp, width), jnp.float32),
                jax.ShapeDtypeStruct((nwp, width), self.argmin_dtype),
            ],
            interpret=self.interpret,
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=DEFAULT_NUM_WARPS,
                                               num_stages=1),
            name="rowlane_backup",
        )(v2p, *args, lane_meta)

    # ---------------------------------------------- padded-carry surface
    @property
    def carry_rows(self) -> int:
        """Row count of the padded table (padded-carry mode)."""
        return self.pad_top + self.NWp + self.pad_bot

    @property
    def carry_shape(self) -> tuple:
        """Shape of the padded-carry table."""
        return (self.carry_rows, self.table_width)

    def pad_carry(self, values: jax.Array) -> jax.Array:
        """State-shaped values -> the zero-padded table."""
        v2 = values.reshape(self.NW, self.NE)
        return jnp.pad(v2, ((self.pad_top,
                             self.NWp - self.NW + self.pad_bot),
                            (self.lane_pad,
                             self.table_width - self.lane_pad - self.NE)))

    def sweep_carry(self, v2p: jax.Array):
        """One sweep in padded-carry mode: ``v2p -> (v2p', argmin_padded)``.

        The returned values array IS the next sweep's carry (pads
        re-zeroed in-kernel) — no per-sweep pad/slice copies (engine
        integration: value_iteration_finite/converged).
        """
        if not self.carry_padded:
            raise ValueError("backup was not built with carry_padded=True")
        return self._sweep_padded(v2p, self.sweep_args, self.carry_rows,
                                  carry=True)

    def unpad_values(self, v2p: jax.Array) -> jax.Array:
        """Carry table -> FLAT (NW, NE) values (callers reshape to the
        state shape where they need it)."""
        return v2p[self.pad_top:self.pad_top + self.NW,
                   self.lane_pad:self.lane_pad + self.NE]

    unpad_argmin = unpad_values

    def __call__(self, values: jax.Array) -> BackupResult:
        if self.carry_padded:
            out = self.sweep_carry(self.pad_carry(values))
            return BackupResult(
                self.unpad_values(out[0]).reshape(self.state_shape),
                self.unpad_argmin(out[1]).reshape(self.state_shape))
        out = self._sweep_padded(self.pad_carry(values), self.sweep_args,
                                 self.NWp)
        vals = out[0][:self.NW, :self.NE].reshape(self.state_shape)
        args_out = out[1][:self.NW, :self.NE].reshape(self.state_shape)
        return BackupResult(vals, args_out)


def build_pallas_backup_6d(plan: InterpPlan, cost_terms, **kw) -> PallasBackup6D:
    return PallasBackup6D(plan, cost_terms, **kw)


def union_live_sets(backups) -> tuple:
    """Superset ``(w_taps, row_combos, e_taps, lane_combos)`` covering every
    given :class:`PallasBackup6D` — rebuild each with ``live_sets=`` this to
    give them all one treedef (the EP-stacking requirement; see
    ``__init__``). Per-axis taps are re-derived from the unioned combos so
    the pair stays self-consistent."""
    def combo_union(field):
        s = set()
        for b in backups:
            s |= {tuple(c) for c in getattr(b, field)}
        return tuple(sorted(s))

    row_combos = combo_union("row_combos")
    lane_combos = combo_union("lane_combos")
    nr = len(backups[0].w_taps)
    ncl = len(backups[0].e_taps)
    w_taps = tuple(tuple(sorted({c[k] for c in row_combos}))
                   for k in range(nr))
    e_taps = tuple(tuple(sorted({c[k] for c in lane_combos}))
                   for k in range(ncl))
    return (w_taps, row_combos, e_taps, lane_combos)


@jax.tree_util.register_pytree_node_class
class PermutedRowLaneBackup:
    """Row/lane kernel behind a state-axis permutation.

    Problems whose NATURAL axis order is not row/lane-separable often are
    under a permutation — pos-att channels (x, v, theta, omega) become
    separable as rows=(v, omega) (the action-coupled axes), lanes=
    (x, theta) (pos-att/Solver_pos_att.m:299-328: x' = x + h v,
    theta' = theta + h omega depend on no control). Wraps a
    :class:`PallasBackup6D` built on the permuted plan; transposes the
    value table in and the results back out (state-sized copies, trivial
    next to the backup itself).
    """

    traced_argument = True

    def __init__(self, plan: InterpPlan, cost_terms, perm, *, row_axes: int,
                 **kw):
        d = plan.ndim
        if sorted(perm) != list(range(d)):
            raise ValueError(f"perm {perm} is not a permutation of 0..{d-1}")
        self.perm = tuple(perm)
        self.inv = tuple(self.perm.index(k) for k in range(d))
        ap = self.perm + (d,)          # action axis stays last

        def t(a):
            a = jnp.asarray(a)
            if a.ndim != d + 1:
                a = a.reshape((1,) * (d + 1 - a.ndim) + a.shape)
            return jnp.transpose(a, ap)

        plan_p = InterpPlan(
            lo=tuple(t(plan.lo[k]) for k in self.perm),
            frac=tuple(t(plan.frac[k]) for k in self.perm),
            grid_shape=tuple(plan.grid_shape[k] for k in self.perm),
        )
        terms = (list(cost_terms) if isinstance(cost_terms, (tuple, list))
                 else [cost_terms])
        self.bk = PallasBackup6D(plan_p, [t(c) for c in terms],
                                 row_axes=row_axes, **kw)

    def __call__(self, values: jax.Array) -> BackupResult:
        res = self.bk(jnp.transpose(values, self.perm))
        return BackupResult(jnp.transpose(res.values, self.inv),
                            jnp.transpose(res.argmin, self.inv))

    def tree_flatten(self):
        return (self.bk,), (self.perm, self.inv)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        obj.perm, obj.inv = aux
        obj.bk = leaves[0]
        return obj
