"""Multilinear gridded interpolation with MATLAB ``griddedInterpolant`` parity.

The reference evaluates ``J_{k+1}(f(x,u))`` with a prebuilt linear
``griddedInterpolant`` (test/Dynamic_Solver.m:83,207;
pos-att/Solver_pos_att.m:264-272). Two semantics are load-bearing
(SURVEY.md §7 "hard parts"):

* **linear extrapolation** outside the grid — MATLAB's default for 'linear'
  interpolants; the reference never clamps. We reproduce it by clamping the
  *cell index* to ``[0, n-2]`` while leaving the fractional weight unclamped
  (weights < 0 or > 1 extrapolate the edge cell linearly).
* evaluation on **rectilinear** (not necessarily uniform) axes — the pos-att
  ``sym_linspace`` axes have different spacing on each side of zero
  (pos-att/Solver_pos_att.m:906-918).

Because all reference problems are time-invariant, the query points are fixed
across stages, so the expensive part — locating each query in the grid — is
done ONCE on the host side of the stage loop ("interpolation plan"), and the
per-stage work is a pure gather + fused-multiply-add that XLA keeps on-chip.

Plans hold one (lo, frac) pair per state axis with *broadcast-shaped* arrays:
separable dynamics (e.g. pos-att: x' depends only on (x,v), w' only on (w,u))
keep the plan small; XLA broadcasts lazily inside the fused backup.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "axis_locate",
    "AffineAxes",
    "affine_axes",
    "nearest_cell_index",
    "InterpPlan",
    "build_plan",
    "interp_apply",
    "interp_eval",
    "nearest_eval",
]


def axis_locate(axis_vals, queries, dtype=jnp.float32):
    """Locate queries on one strictly-ascending 1-D axis.

    Returns ``(lo, frac)``: cell index clipped to ``[0, n-2]`` (int32) and the
    unclamped fractional position in that cell (``dtype``). ``frac`` outside
    ``[0, 1]`` encodes linear extrapolation, matching MATLAB
    ``griddedInterpolant(..., 'linear')`` default extrapolation.
    """
    g = jnp.asarray(axis_vals, dtype=dtype)
    q = jnp.asarray(queries, dtype=dtype)
    n = g.shape[0]
    # searchsorted('scan') carries its index tensor through a while loop;
    # a flat carry keeps that loop's layout simple for any query rank.
    # Flatten for the search, reshape after — elementwise semantics are
    # unchanged.
    lo = jnp.clip(jnp.searchsorted(g, q.reshape(-1), side="right") - 1,
                  0, n - 2).reshape(q.shape)
    g_lo = jnp.take(g, lo)
    g_hi = jnp.take(g, lo + 1)
    frac = (q - g_lo) / (g_hi - g_lo)
    return lo.astype(jnp.int32), frac


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InterpPlan:
    """Precomputed interpolation stencil for a fixed set of query points.

    ``lo[k]`` / ``frac[k]`` are broadcast-compatible with the full query shape
    (typically ``(*state_shape, n_actions)``); ``grid_shape`` is the shape of
    the value table being interpolated. Registered as a pytree with
    ``grid_shape`` static, so plans pass through ``jit``/``scan`` unchanged.
    """

    lo: tuple[jax.Array, ...]
    frac: tuple[jax.Array, ...]
    grid_shape: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def ndim(self) -> int:
        return len(self.grid_shape)

    @property
    def query_shape(self) -> tuple[int, ...]:
        return np.broadcast_shapes(*(x.shape for x in self.lo), *(x.shape for x in self.frac))


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class PlanShape:
    """Shape-only stand-in for an :class:`InterpPlan`.

    Engines driven by an explicit ``backup`` use the plan solely for
    ``grid_shape``/``query_shape`` metadata — passing this instead of the
    real plan keeps multi-GB plan arrays out of device memory for
    envelope-scale solves (registered static: contributes no tracers).
    """

    grid_shape: tuple
    query_shape: tuple

    @property
    def ndim(self) -> int:
        return len(self.grid_shape)

    @classmethod
    def of(cls, plan) -> "PlanShape":
        return cls(tuple(plan.grid_shape), tuple(plan.query_shape))


def build_plan(axes: Sequence[np.ndarray], queries: Sequence, dtype=jnp.float32,
               edge: str = "extrapolate") -> InterpPlan:
    """Build an :class:`InterpPlan` for per-axis query coordinate arrays.

    ``queries[k]`` holds the coordinate of every query point along state axis
    ``k``; arrays may be broadcast-shaped (singleton dims where the coordinate
    does not vary).

    ``edge`` — value-table behavior for out-of-grid queries (SURVEY.md §7
    "explicit edge policy as a config"):

    * ``"extrapolate"`` (default): MATLAB ``griddedInterpolant`` parity —
      fracs outside [0,1] extrapolate the edge cell linearly, exactly as the
      reference's backups do (test/Dynamic_Solver.m:207). CAUTION: linear
      extrapolation makes the Bellman operator locally EXPANSIVE (weight
      magnitudes ``|1-f|+|f| >> 1``) at cells whose dynamics exit the grid;
      value iteration can then diverge at those edge cells once f32 rounding
      flips the argmin toward the extrapolating action — observed on the
      attitude roll axis at the reference's own 5999-sweep horizon with the
      gather oracle itself, i.e. the hazard is inherent to the reference's
      semantics, not to any one kernel.
    * ``"clamp"``: project out-of-grid queries onto the grid boundary
      (fracs clipped to [0,1]). Every interpolation weight stays in [0,1],
      so backups are non-expansive and value iteration is unconditionally
      stable. Differs from the reference ONLY at queries that leave the
      grid.
    """
    if len(axes) != len(queries):
        raise ValueError(f"got {len(axes)} axes but {len(queries)} query arrays")
    if edge not in ("extrapolate", "clamp"):
        raise ValueError(f"unknown edge policy {edge!r}")
    lo, frac = [], []
    for ax, q in zip(axes, queries):
        l, f = axis_locate(ax, q, dtype=dtype)
        if edge == "clamp":
            f = jnp.clip(f, 0.0, 1.0)
        lo.append(l)
        frac.append(f)
    return InterpPlan(tuple(lo), tuple(frac), tuple(int(np.asarray(a).size) for a in axes))


def interp_apply(values: jax.Array, plan: InterpPlan) -> jax.Array:
    """Evaluate the multilinear interpolant of ``values`` at the plan's queries.

    ``values`` has shape ``plan.grid_shape``; the result has the broadcast
    query shape. Implemented as ``2**d`` corner gathers from the flattened
    table with product weights — XLA fuses the weight algebra into the gather
    consumers and keeps the value table device-resident.
    """
    d = plan.ndim
    if values.shape != plan.grid_shape:
        raise ValueError(f"values shape {values.shape} != grid shape {plan.grid_shape}")
    strides = np.ones(d, dtype=np.int64)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * plan.grid_shape[k + 1]
    flat = values.reshape(-1)

    out = None
    for corner in itertools.product((0, 1), repeat=d):
        idx = None
        w = None
        for k in range(d):
            ik = plan.lo[k] + corner[k] if corner[k] else plan.lo[k]
            term = ik * int(strides[k]) if strides[k] != 1 else ik
            idx = term if idx is None else idx + term
            fk = plan.frac[k] if corner[k] else (1.0 - plan.frac[k])
            w = fk if w is None else w * fk
        contrib = w * jnp.take(flat, idx)
        out = contrib if out is None else out + contrib
    return out


def nearest_eval(values, axes: Sequence[np.ndarray], points, dtype=jnp.float32):
    """Nearest-neighbor table lookup, MATLAB ``'nearest'`` interpolant parity.

    The reference wraps its policies in 'nearest' griddedInterpolants for
    rollout (Solver_position.m:144-146; Solver_pos_att.m:851-861). Outside
    the grid the nearest edge point is used (MATLAB 'nearest' extrapolation).

    Exact-midpoint tie rule — PINNED here (tests/test_interp.py): a query
    exactly halfway between two grid points snaps to the LOWER neighbor
    (strict ``>`` toward the upper). MATLAB does not document
    ``griddedInterpolant('nearest')``'s midpoint side and no MATLAB is
    available in this environment to measure it (``interp1('nearest')`` is
    reported to round the other way); the divergence surface is one policy
    cell at measure-zero query points that no reference rollout hits —
    trajectories reach grid midpoints only by f32 coincidence. If exact
    MATLAB midpoint behavior is ever measured to differ, flip the
    comparison to ``>=`` and update the pinned test.
    """
    idx = []
    for ax, q in zip(axes, points):
        g = jnp.asarray(ax, dtype=dtype)
        q = jnp.asarray(q, dtype=dtype)
        lo = jnp.clip(jnp.searchsorted(g, q, side="right") - 1, 0, g.shape[0] - 2)
        pick_hi = (q - jnp.take(g, lo)) > (jnp.take(g, lo + 1) - q)
        idx.append(jnp.where(pick_hi, lo + 1, lo))
    flat = jnp.asarray(values).reshape(-1)
    strides = np.ones(len(axes), dtype=np.int64)
    # np.shape (not np.asarray) so traced axis arrays work under jit
    shape = tuple(int(np.shape(a)[0]) for a in axes)
    for k in range(len(axes) - 2, -1, -1):
        strides[k] = strides[k + 1] * shape[k + 1]
    lin = idx[0] * int(strides[0])
    for k in range(1, len(axes)):
        lin = lin + idx[k] * int(strides[k])
    return jnp.take(flat, lin)


class AffineAxes(NamedTuple):
    """Arithmetic locate metadata for piecewise-uniform axes (pure pytree).

    Every reference grid is ``linspace`` (one uniform piece) or
    ``sym_linspace`` (two uniform pieces meeting at zero — grids.py); on such
    axes the ``searchsorted`` in :func:`nearest_eval` is replaceable by a
    two-piece affine ``floor((q - lo)/dx)`` — O(1) arithmetic instead of a
    binary-search chain. Inside a rollout scan this is the difference between
    ~6 sequential ops per axis per step and one fused elementwise block
    (the serving-mode lever; models/pos_att._closed_loop).

    Leaves are arrays over a trailing axis-index dimension K (optionally
    with leading batch dims, e.g. one row per channel), so locating all K
    coordinates of a query point is one vectorized expression:

    * ``a0``/``brk``: first grid point and the piece breakpoint value,
    * ``d_left``/``d_right``: uniform spacing of each piece (equal when the
      axis has a single piece),
    * ``z``: float index where the right piece starts (0 for uniform axes),
    * ``n``: float point count (for the cell clip),
    * ``axmat``: the axis values padded to a common length — the
      nearest-neighbor midpoint comparison uses the TRUE grid values, so the
      pinned lower-snap tie rule (:func:`nearest_eval`) is preserved exactly.
    """

    a0: jax.Array
    brk: jax.Array
    d_left: jax.Array
    d_right: jax.Array
    z: jax.Array
    n: jax.Array
    axmat: jax.Array


def affine_axes(axes: Sequence[np.ndarray], dtype=np.float32,
                host: bool = False) -> AffineAxes:
    """Build :class:`AffineAxes` for axes with at most two uniform pieces.

    Raises ``ValueError`` for axes that are not piecewise-uniform with a
    single breakpoint (callers fall back to :func:`nearest_eval`).

    ``host=True`` keeps the leaves numpy (no device placement) — for
    callers that batch several AffineAxes host-side and ship the result
    in one ``device_put`` instead of one transfer per leaf).
    """
    a0, brk, dl, dr, z, n = [], [], [], [], [], []
    max_n = max(np.asarray(a).size for a in axes)
    mats = []
    for ax in axes:
        a = np.asarray(ax, np.float64)
        d = np.diff(a)
        if a.size < 2:
            raise ValueError("axis needs >= 2 points")
        changes = np.nonzero(~np.isclose(d[1:], d[:-1], rtol=1e-4))[0]
        if changes.size == 0:
            zi = 0
            d_l = d_r = float(d.mean())
        elif changes.size == 1:
            zi = int(changes[0]) + 1          # cell zi-1 is the last left cell
            d_l = float(d[:zi].mean())
            d_r = float(d[zi:].mean())
        else:
            raise ValueError(
                "axis is not piecewise-uniform with <= 2 pieces; use "
                "nearest_eval/searchsorted instead")
        a0.append(float(a[0]))
        brk.append(float(a[zi]))
        dl.append(d_l)
        dr.append(d_r)
        z.append(float(zi))
        n.append(float(a.size))
        mats.append(np.pad(a.astype(dtype), (0, max_n - a.size),
                           mode="edge"))
    cast = (lambda v: np.asarray(v, dtype)) if host \
        else (lambda v: jnp.asarray(np.asarray(v, dtype)))  # noqa: E731
    stacked = np.stack(mats)
    return AffineAxes(cast(a0), cast(brk), cast(dl), cast(dr), cast(z),
                      cast(n), stacked if host else jnp.asarray(stacked))


def nearest_cell_index(aff: AffineAxes, q: jax.Array) -> jax.Array:
    """Per-axis nearest grid indices for query coordinates ``q[..., K]``.

    Equivalent to :func:`nearest_eval`'s index math (same edge clamp, same
    midpoint comparison against the true grid values) with the
    ``searchsorted`` replaced by the two-piece affine locate. Off-by-one
    cell picks are possible only when a query sits within one f32 ulp of a
    grid point — where both candidate cells snap to that same point.
    """
    lo_f = jnp.where(
        q < aff.brk,
        jnp.floor((q - aff.a0) / aff.d_left),
        aff.z + jnp.floor((q - aff.brk) / aff.d_right))
    lo = jnp.clip(lo_f, 0.0, aff.n - 2.0).astype(jnp.int32)
    # axmat rows broadcast against q's batch dims (axmat (..., K, max_n),
    # q (..., K)): flat gather with a per-row base offset
    max_n = aff.axmat.shape[-1]
    row_base = (jnp.arange(aff.axmat.size // max_n, dtype=jnp.int32)
                .reshape(aff.axmat.shape[:-1]) * max_n)
    flat = aff.axmat.reshape(-1)
    g_lo = flat[row_base + lo]
    g_hi = flat[row_base + lo + 1]
    pick_hi = (q - g_lo) > (g_hi - q)
    return lo + pick_hi.astype(jnp.int32)


def interp_eval(values, axes: Sequence[np.ndarray], points, dtype=jnp.float32):
    """One-shot interpolation: locate + apply (for rollouts / policy lookup).

    ``points``: sequence of per-axis coordinate arrays (broadcastable).
    """
    plan = build_plan(axes, points, dtype=dtype)
    return interp_apply(jnp.asarray(values, dtype=dtype), plan)
