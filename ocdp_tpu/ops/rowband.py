"""Row-band Bellman backup for separable 2-D problems (attitude axes).

The simplified attitude problem (attitude-control/Solver_attitude.m:236-247)
has a special query geometry the generic banded stencil can't exploit:

* axis 0 (omega): ``w' = w + h*u/J`` — on a uniform axis the cell index is
  ``clip(row + s_a, 0, N1-2)`` with a PER-ACTION integer shift ``s_a``, so
  per action the interpolation is two statically-shifted row slabs (plus
  replicated edge rows where the clamp saturates);
* axis 1 (theta): ``t' = t + h*w*c`` — the lane shift ``d_r`` depends only
  on the ROW, so rows partition into a handful of contiguous bands, each a
  pair of statically-shifted lane slices.

The generic stencil serves the same queries with ``O(taps^2 * A)`` dense
weight tensors (``[off==t](1-f)+[off==t-1]f`` over the full (N1,N2,A) grid
per tap — elementwise-bound even after the edge-split optimization).
This operator reads the SAME plan and performs the same
multilinear interpolation with ~6 statically-sliced FMA passes per action
(exact plan fracs as (N1,1)/(N1,N2) broadcasts; no tap masks at all), then
first-min over actions — an ~4x FLOP cut.

Numerics: identical corner reads and fractional weights as the gather
oracle, associated as ``(1-f)*lo + f*hi`` per axis; results match other
backups to f32 rounding (argmin ties may flip at exact-tie cells). Not used
by the bitwise sharded/halo engines.

Raises :class:`RowBandStructureError` when the plan doesn't have this
geometry (callers fall back to the stencil).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .backup import BackupResult
from .interp import InterpPlan

__all__ = ["RowBandBackup2D", "RowBandStructureError", "build_rowband_backup"]


class RowBandStructureError(ValueError):
    """The plan's query geometry doesn't factor into row bands."""


class RowBandBackup2D:
    """Callable backup op ``values -> BackupResult`` (see module docstring)."""

    def __init__(self, plan: InterpPlan, stage_cost):
        if plan.ndim != 2:
            raise RowBandStructureError("row-band backup is 2-D only")
        N1, N2 = plan.grid_shape
        qshape = plan.query_shape
        if qshape[:2] != (N1, N2):
            raise RowBandStructureError(
                f"query shape {qshape} doesn't cover the {plan.grid_shape} grid")
        A = qshape[-1]

        lo0, fr0 = np.asarray(plan.lo[0]), np.asarray(plan.frac[0])
        lo1, fr1 = np.asarray(plan.lo[1]), np.asarray(plan.frac[1])
        # structural shape requirements: axis-0 queries independent of the
        # lane axis, axis-1 queries independent of the action axis
        if lo0.shape[1] != 1 or fr0.shape[1] != 1:
            raise RowBandStructureError(
                f"axis-0 queries vary along axis 1 (lo shape {lo0.shape})")
        if lo1.shape[-1] != 1 or fr1.shape[-1] != 1:
            raise RowBandStructureError(
                f"axis-1 queries vary with the action (lo shape {lo1.shape})")
        lo0 = np.broadcast_to(lo0.reshape(lo0.shape[0], -1), (N1, A))
        fr0 = np.broadcast_to(fr0.reshape(fr0.shape[0], -1), (N1, A))
        lo1 = np.broadcast_to(lo1.reshape(-1, N2), (N1, N2))
        fr1 = np.broadcast_to(fr1.reshape(-1, N2), (N1, N2))

        rows = np.arange(N1)
        mid = N1 // 2
        self.shifts = []
        for a in range(A):
            s_a = int(lo0[mid, a]) - mid
            if not np.array_equal(lo0[:, a], np.clip(rows + s_a, 0, N1 - 2)):
                raise RowBandStructureError(
                    f"action {a}: axis-0 indices are not a clamped "
                    f"constant shift")
            self.shifts.append(s_a)

        lanes = np.arange(N2)
        # per-row shift = modal lo1 - lane (robust to a clamped middle lane);
        # then require the clamped-shift identity EXACTLY — f32 rounding at
        # cell boundaries can break it on coarse grids, in which case this
        # plan is not row-band-representable and callers fall back
        diff = lo1 - lanes[None, :]
        d = np.empty(N1, np.int64)
        for r in range(N1):
            vals, counts = np.unique(diff[r], return_counts=True)
            d[r] = vals[np.argmax(counts)]
        if not np.array_equal(lo1, np.clip(lanes[None, :] + d[:, None],
                                           0, N2 - 2)):
            raise RowBandStructureError(
                "axis-1 indices are not a clamped per-row shift")
        # contiguous runs of constant lane shift
        cut = np.flatnonzero(np.diff(d)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [N1]])
        self.bands = [(int(r0), int(r1), int(d[r0]))
                      for r0, r1 in zip(starts, ends)]
        self.pad_lo = max(0, -int(d.min()))
        self.pad_hi = max(0, int(d.max()))

        self.grid_shape = (N1, N2)
        self.n_actions = A
        self.fr0 = jnp.asarray(fr0, jnp.float32)            # (N1, A)
        self.fr1 = jnp.asarray(fr1, jnp.float32)            # (N1, N2)

        terms = (list(stage_cost) if isinstance(stage_cost, (tuple, list))
                 else [stage_cost])
        cost = np.zeros(qshape, np.float32)
        for t in terms:
            cost = cost + np.asarray(t, np.float32)
        self.cost = jnp.asarray(np.ascontiguousarray(
            np.moveaxis(cost, -1, 0)))                       # (A, N1, N2)

    def _axis0(self, v, a):
        """Per-action omega interpolation: (N1, N2) -> (N1, N2)."""
        N1, _ = self.grid_shape
        s = self.shifts[a]
        f = self.fr0[:, a][:, None]                          # (N1, 1)
        k0 = max(0, -s)              # rows clamped at the low edge
        k1 = max(0, s + 1)           # rows clamped at the high edge
        parts = []
        if k0:
            parts.append((1.0 - f[:k0]) * v[0:1] + f[:k0] * v[1:2])
        m0, m1 = k0, N1 - k1         # interior rows: lo = row + s unclamped
        if m1 > m0:
            parts.append((1.0 - f[m0:m1]) * v[m0 + s:m1 + s]
                         + f[m0:m1] * v[m0 + s + 1:m1 + s + 1])
        if k1:
            parts.append((1.0 - f[m1:]) * v[N1 - 2:N1 - 1]
                         + f[m1:] * v[N1 - 1:N1])
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)

    def _axis1(self, w):
        """Theta interpolation of an omega-interpolated table.

        Clamped edge lanes are served EXACTLY by edge-replicated column
        padding: the lo corner reads ``w[:, clip(l+t, 0, N2-2)]`` and the hi
        corner ``w[:, clip(l+t+1, 1, N2-1)]``, so two padded views (first/
        last interior column replicated into the pad) turn every clamped
        read into the same static slice as the interior — no gathers, no
        per-lane masks (plan fracs already carry the extrapolation
        weights)."""
        N1, N2 = self.grid_shape
        PL, PH = self.pad_lo, self.pad_hi

        def padded(first_col, body, last_col):
            parts = []
            if PL:
                parts.append(jnp.broadcast_to(first_col, (N1, PL)))
            parts.append(body)
            parts.append(jnp.broadcast_to(last_col, (N1, PH + 1)))
            return jnp.concatenate(parts, axis=1)      # (N1, N2 + PL + PH)

        wp_lo = padded(w[:, 0:1], w[:, 0:N2 - 1], w[:, N2 - 2:N2 - 1])
        wp_hi = padded(w[:, 1:2], w[:, 1:N2], w[:, N2 - 1:N2])
        parts = []
        for r0, r1, t in self.bands:
            sl = wp_lo[r0:r1, PL + t:PL + t + N2]
            sh = wp_hi[r0:r1, PL + t:PL + t + N2]
            f = self.fr1[r0:r1]
            parts.append((1.0 - f) * sl + f * sh)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)

    @partial(jax.jit, static_argnums=0)
    def __call__(self, values: jax.Array) -> BackupResult:
        best_v = best_a = None
        for a in range(self.n_actions):
            total = self._axis1(self._axis0(values, a)) + self.cost[a]
            if best_v is None:
                best_v = total
                best_a = jnp.zeros(self.grid_shape, jnp.int32)
            else:
                better = total < best_v  # strict: first minimum wins ties
                best_v = jnp.where(better, total, best_v)
                best_a = jnp.where(better, jnp.int32(a), best_a)
        return BackupResult(best_v, best_a)


def build_rowband_backup(plan: InterpPlan, stage_cost) -> RowBandBackup2D:
    return RowBandBackup2D(plan, stage_cost)
