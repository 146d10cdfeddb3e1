"""Shear-gather Bellman backup: pre-gathered corner tables + tiny select bands.

The fast path for problems whose interpolation geometry is (near-)affine in
the state indices — Kirk's LTI regulator above all (x' = A x + B u,
test/Dynamic_Solver.m:184-194). The two generic fast paths scale badly on
the full Kirk workload (100x100 x 1000):

* the banded stencil (``ops/stencil.py``) is elementwise-bound: its band
  must cover the query drift across ALL state cells (state shear + stretch
  + extrapolation clamping = 27-47 taps), costing ~1500 elementwise ops
  per state-action eval;
* anything that gathers per QUERY (``ops/basegather.py``) issues 1e7
  gathers per sweep.

This module does neither. All interpolation geometry is static across
sweeps, so on the host we fit, per state axis k, an affine **shear map**

    G_k(p) = clip(round(c_k + sum_j M_kj p_j), 0, n_k - 2)

over an extended index lattice p (state index + small search offsets +
per-action-chunk shifts). Once per sweep the 2^d corner tables

    T_corner[p] = V[G_0(p) + corner_0, ..., G_{d-1}(p) + corner_{d-1}]

are built with 2^d TABLE-sized static gathers (~1e4 elements — micro-
seconds, not the 1e7 per-query gathers basegather pays). Because G tracks
the query map, each query's interpolation corner sits at a SMALL, host-
verified offset delta from its own cell: the runtime selects it with a
per-axis select-chain over a few static slices of a per-chunk window —
``sum_delta [j_k(q) == delta] * W[x + delta]`` — which is an exact copy
(zeros add exactly; exactly one match, verified at build). Per-eval cost
is ~150-200 elementwise ops instead of ~1500.

Weight algebra and summation order replicate ``ops/backup.py``'s corner
loop exactly (same products, same corner order), so results are bitwise
equal to the gather oracle — including MATLAB linear extrapolation
(unclamped fracs) and first-min tie-breaking across action chunks
(strict ``<`` in ascending order, test/Dynamic_Solver.m:209).

Build fails loudly (ValueError) if the fitted shear cannot cover every
query within ``max_band`` offsets — fall back to the banded stencil then.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from .backup import BackupResult
from .interp import InterpPlan

__all__ = ["ShearBandError", "ShearGatherBackup", "build_sheargather_backup"]


class ShearBandError(ValueError):
    """The fitted shear cannot serve this (geometry, action_chunk): the
    search band or live-pair scratch would be too large. Retrying with a
    smaller chunk may succeed (kirk._build_shear_walkdown does)."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShearGatherBackup:
    """Precomputed shear-gather backup operator (one problem, fixed plan).

    Pass as a traced jit ARGUMENT (pytree; ``traced_argument``): the
    j/frac/cost stacks are 100s of MB for the full Kirk workload and must
    not become compile-payload constants (remote-compile limit, NOTES.md).
    """

    corner_idx: jax.Array   # (T_cells,) int32 flat V indices of G(p)
    j_idx: tuple[jax.Array, ...]   # per axis: (C, *state, chunk) int8 band pos
    frac: tuple[jax.Array, ...]    # per axis: (C, *state, chunk) f32 unclamped
    cost: jax.Array                # (C, *state, chunk) f32 stage cost
    # static metadata
    grid_shape: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    state_shape: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    t_shape: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_band: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    # per-axis lattice refinement: axes whose own shear slope exceeds 1
    # (Kirk axis 1: a22 = 1.1591) step G by >1 cell per lattice step and
    # would SKIP corner indices; an s_k-fine lattice (G slope/s_k <= 1 per
    # step) makes every index reachable. Runtime reads stride by s_k.
    upsample: tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    # per-chunk window origins in T — STATIC, so every per-chunk read of a
    # corner table is a static slice XLA can fuse into the select chain
    # (a traced dynamic_slice per (chunk, corner) measurably serializes).
    # The chunk loop is a Python unroll for the same reason.
    win_start: tuple[tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True))
    chunk: int = dataclasses.field(metadata=dict(static=True))
    n_actions: int = dataclasses.field(metadata=dict(static=True))

    traced_argument = True   # see class docstring

    def __call__(self, values: jax.Array) -> BackupResult:
        d = len(self.grid_shape)
        v_flat = values.reshape(-1)
        strides = np.ones(d, np.int64)
        for k in range(d - 2, -1, -1):
            strides[k] = strides[k + 1] * self.grid_shape[k + 1]

        # 2^d corner tables in ONE row-gather. Corner (c_0..c_{d-1}) lives
        # at corner_idx + sum c_k*stride_k (G <= n-2, so +1 per axis never
        # leaves the true grid — extrapolation is in the unclamped fracs,
        # ops/interp.py:46-61). A gather's cost tracks the number of
        # INDICES more than the slice width, so stack 2^d statically-
        # shifted copies of v_flat on the minor axis and gather each
        # lattice point's corners as one row. Bitwise-identical elements
        # either way.
        corner_list = list(itertools.product((0, 1), repeat=d))
        offs = [int(sum(c * strides[k] for k, c in enumerate(corner)))
                for corner in corner_list]
        vp = jnp.pad(v_flat, (0, max(offs)))
        v4 = jnp.stack([jax.lax.dynamic_slice(vp, (o,), (v_flat.shape[0],))
                        for o in offs], axis=-1)      # (cells, 2^d)
        g = jnp.take(v4, self.corner_idx, axis=0)     # (T_cells, 2^d)
        corners = {corner: g[:, ci].reshape(self.t_shape)
                   for ci, corner in enumerate(corner_list)}

        # Phase-split every corner table along upsampled axes (ONE strided
        # slice per (corner, phase) per sweep) so the per-(chunk, delta)
        # leaf reads below are unit-stride slices, which fuse into the
        # select chain (1400+ strided slices per sweep need not).
        phases = list(itertools.product(*[range(s) for s in self.upsample]))
        cphase = {}
        for corner, t in corners.items():
            for ph in phases:
                cphase[corner + ph] = t[tuple(
                    slice(p, None, s) for p, s in zip(ph, self.upsample))]

        best_v = jnp.full(self.state_shape, jnp.inf, jnp.float32)
        best_a = jnp.zeros(self.state_shape, jnp.int32)
        n_chunks = self.n_actions // self.chunk
        for c in range(n_chunks):
            js = tuple(j[c] for j in self.j_idx)
            fracs = tuple(f[c] for f in self.frac)
            cost = self.cost[c]
            wstart = self.win_start[c]

            # per-axis band-position masks, shared by all corners
            masks = [[js[k] == delta for delta in range(self.n_band[k])]
                     for k in range(d)]

            def pick(corner):
                """T[s*x + wstart + j(q)] via nested select-chains of
                STATIC unit-stride slices of the phase views (exact copy:
                exactly one mask matches per query; zeros add exactly)."""
                def rec(k, offsets):
                    if k == d:
                        fine = tuple(w + o for w, o in zip(wstart, offsets))
                        ph = tuple(f % s for f, s in
                                   zip(fine, self.upsample))
                        starts = tuple(f // s for f, s in
                                       zip(fine, self.upsample))
                        lims = tuple(st + n for st, n in
                                     zip(starts, self.state_shape))
                        leaf = jax.lax.slice(cphase[corner + ph],
                                             starts, lims)
                        return jnp.expand_dims(leaf, -2)
                    acc = None
                    for delta in range(self.n_band[k]):
                        r = rec(k + 1, offsets + (delta,))
                        term = jnp.where(masks[k][delta], r, 0.0)
                        acc = term if acc is None else acc + term
                    return acc
                return rec(0, ())

            # exact ops/backup.py corner loop: same products, same order
            total = None
            for corner in itertools.product((0, 1), repeat=d):
                w = None
                for k in range(d):
                    fk = fracs[k] if corner[k] else (1.0 - fracs[k])
                    w = fk if w is None else w * fk
                contrib = w * pick(corner)
                total = contrib if total is None else total + contrib
            total = total + cost

            m = jnp.min(total, axis=-2)
            a = jnp.argmin(total, axis=-2).astype(jnp.int32) \
                + c * self.chunk
            better = m < best_v                 # strict: first min wins
            best_v = jnp.where(better, m, best_v)
            best_a = jnp.where(better, a, best_a)
        return BackupResult(best_v, best_a)


def build_sheargather_backup(
    plan: InterpPlan,
    stage_cost,
    *,
    action_chunk: int = 50,
    max_band: int = 9,
) -> ShearGatherBackup:
    """Fit the shear maps, size the search band, assign per-query matches.

    Host-side, once per problem. Raises ValueError when some query's
    corner cannot be reached within ``max_band`` offsets of its cell —
    the geometry is then too far from affine for this path.
    """
    d = plan.ndim
    q_shape = plan.query_shape
    state_shape = q_shape[:-1]
    n_actions = q_shape[-1]
    if n_actions % action_chunk:
        raise ValueError(
            f"action axis {n_actions} not divisible by chunk {action_chunk}")
    n_chunks = n_actions // action_chunk
    n = plan.grid_shape

    lo = [np.broadcast_to(np.asarray(l), q_shape).astype(np.int64)
          for l in plan.lo]
    fr = [np.broadcast_to(np.asarray(f), q_shape).astype(np.float32)
          for f in plan.frac]

    # --- affine fit of lo_k over state indices (interior queries only) ---
    idx_grids = np.meshgrid(*[np.arange(s) for s in state_shape],
                            indexing="ij")
    X = np.stack([g.ravel() for g in idx_grids] + [np.ones(
        int(np.prod(state_shape)))], axis=1).astype(np.float64)  # (cells, d+1)
    mid = n_actions // 2
    coef = []
    for k in range(d):
        y = lo[k][..., mid].reshape(-1).astype(np.float64) \
            + fr[k][..., mid].reshape(-1)          # continuous position
        interior = (lo[k][..., mid].reshape(-1) > 0) & \
                   (lo[k][..., mid].reshape(-1) < n[k] - 2)
        if interior.sum() >= d + 1:
            c, *_ = np.linalg.lstsq(X[interior], y[interior], rcond=None)
        else:
            c, *_ = np.linalg.lstsq(X, y, rcond=None)
        coef.append(c)                              # (d slopes, const)
    M = np.array([[coef[k][j] for j in range(d)] for k in range(d)])

    # --- lattice refinement (see ShearGatherBackup.upsample) ---
    ups = tuple(max(1, int(np.ceil(abs(M[k, k]) - 1e-9))) for k in range(d))
    s_arr = np.asarray(ups, np.float64)

    # --- per-chunk shifts (action drift rides the window start). Solved
    # JOINTLY so cross slopes (M_kj, j != k) don't contaminate other axes'
    # bands: G moves by M @ (cb/s) when the window shifts by cb.
    cb = np.zeros((n_chunks, d), np.int64)
    pred_mid = [X @ coef[k] for k in range(d)]      # (cells,) per axis
    Minv = np.linalg.inv(M) if abs(np.linalg.det(M)) > 1e-9 else None
    for c in range(n_chunks):
        D = np.zeros(d)
        for k in range(d):
            sl = lo[k][..., c * action_chunk:(c + 1) * action_chunk]
            fs = fr[k][..., c * action_chunk:(c + 1) * action_chunk]
            pos = sl + fs                            # continuous positions
            D[k] = np.median(
                pos.reshape(-1, action_chunk)[:, action_chunk // 2]
                - pred_mid[k])
        if Minv is not None:
            steps = Minv @ D
        else:
            # sign-preserving clamped diagonal: |slope| floored at 0.25
            # but the DIRECTION kept (a negated slope must shift cb the
            # other way or the band doubles instead of shrinking)
            dg = np.diag(M)
            sg = np.where(dg < 0, -1.0, 1.0)
            steps = D / (sg * np.maximum(np.abs(dg), 0.25))
        cb[c] = np.round(steps * s_arr).astype(np.int64)

    # --- search band: residual of lo vs shear prediction, padded +-1 ---
    band_lo = np.zeros(d, np.int64)
    band_hi = np.zeros(d, np.int64)
    for k in range(d):
        # prediction at each chunk's shifted home lattice point
        shift_k = (M[k] @ (cb.T / s_arr[:, None]))   # (C,)
        pred = pred_mid[k].reshape(state_shape)[None, ..., None] \
            + shift_k[(slice(None),) + (None,) * (len(state_shape) + 1)]
        # pred: (C, *state, 1); lo chunked: (C, *state, chunk)
        lo_c = np.moveaxis(
            lo[k].reshape(state_shape + (n_chunks, action_chunk)), -2, 0)
        # the shear map rounds+CLIPS pred at integer lattice points (clip
        # mirrors lo's own edge clamping, so extrapolating edge queries
        # match at small delta); estimate the delta range from the clipped
        # residual over the own-axis FINE slope, pad +-1, verify below.
        r = lo_c - np.clip(np.round(pred).astype(np.int64), 0, n[k] - 2)
        slope = max(abs(M[k, k]) / ups[k], 0.25)
        band_lo[k] = int(np.floor(r.min() / slope)) - 1
        band_hi[k] = int(np.ceil(r.max() / slope)) + 1
        if band_hi[k] - band_lo[k] + 1 > max_band:
            raise ShearBandError(
                f"axis {k}: band {band_hi[k]-band_lo[k]+1} exceeds "
                f"max_band={max_band}; geometry too far from affine")

    # --- T lattice extent (covers s*i + delta + cb for all chunks) ---
    p_min = [int(band_lo[k] + cb[:, k].min()) for k in range(d)]
    p_max = [int(ups[k] * (state_shape[k] - 1) + band_hi[k]
                 + cb[:, k].max()) for k in range(d)]
    t_shape = tuple(p_max[k] - p_min[k] + 1 for k in range(d))

    # shear maps over the T lattice (fine coordinates: p/s per axis)
    t_grids = np.meshgrid(*[np.arange(p_min[k], p_max[k] + 1)
                            for k in range(d)], indexing="ij")
    G = []
    for k in range(d):
        g = coef[k][d] + sum(M[k, j] * t_grids[j] / ups[j] for j in range(d))
        G.append(np.clip(np.round(g).astype(np.int64), 0, n[k] - 2))

    strides = np.ones(d, np.int64)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * n[k + 1]
    corner_idx = sum(G[k] * strides[k] for k in range(d)).reshape(-1)
    if corner_idx.max() + int(strides.sum()) >= np.iinfo(np.int32).max:
        raise ValueError("table too large for int32 corner indices")

    # --- joint match search: j_k(q) = delta_k with G(i + delta + cb) == lo
    n_band = tuple(int(band_hi[k] - band_lo[k] + 1) for k in range(d))
    lo_c = [np.moveaxis(
        lo[k].reshape(state_shape + (n_chunks, action_chunk)), -2, 0)
        for k in range(d)]                       # (C, *state, chunk)
    j_idx = [np.full((n_chunks,) + state_shape + (action_chunk,), -1,
                     np.int8) for _ in range(d)]
    matched = np.zeros((n_chunks,) + state_shape + (action_chunk,), bool)
    win_start = np.zeros((n_chunks, d), np.int64)
    for c in range(n_chunks):
        for k in range(d):
            win_start[c, k] = band_lo[k] + cb[c, k] - p_min[k]
    # search near the zero offset first so matches cluster tightly around
    # the band center — the band is then TRIMMED to the deltas actually
    # used (the conservative estimate above often over-covers by 2-3x,
    # and runtime cost is 4 * 2 * prod(n_band) elementwise ops per eval).
    zero_pt = tuple(int(-band_lo[k]) for k in range(d))
    order = sorted(itertools.product(*[range(nb) for nb in n_band]),
                   key=lambda ds: sum(abs(ds[k] - zero_pt[k])
                                      for k in range(d)))
    for deltas in order:
        for c in range(n_chunks):
            # G at positions s*i + (band_lo + delta) + cb_c: stride-s slices
            sl = tuple(slice(int(win_start[c, k] + deltas[k]),
                             int(win_start[c, k] + deltas[k])
                             + ups[k] * (state_shape[k] - 1) + 1,
                             ups[k]) for k in range(d))
            ok = np.ones(state_shape + (1,), bool)
            for k in range(d):
                ok = ok & (G[k][sl][..., None] == lo_c[k][c])
            fresh = ok & ~matched[c]
            if fresh.any():
                for k in range(d):
                    j_idx[k][c][fresh] = deltas[k]
                matched[c] |= fresh
    if not matched.all():
        miss = int((~matched).sum())
        raise ShearBandError(
            f"{miss} queries have no in-band shear match; geometry too "
            "far from affine — use the banded stencil")

    # trim each axis's band to the used range; window starts shift along
    used_lo = [int(j_idx[k].min()) for k in range(d)]
    used_hi = [int(j_idx[k].max()) for k in range(d)]
    if any(used_lo) or used_hi != [nb - 1 for nb in n_band]:
        for k in range(d):
            j_idx[k] -= used_lo[k]
            win_start[:, k] += used_lo[k]
        n_band = tuple(used_hi[k] - used_lo[k] + 1 for k in range(d))

    # Device layout: the chunk axis sits SECOND-minor — (C, s0..s_{d-2},
    # chunk, s_last) — so every elementwise op runs along a full state
    # axis in the minor dimension and the per-chunk min/argmin reduces
    # over the second-minor one (a 20-wide minor axis would leave most of
    # each vector op idle).
    def dev_layout(a):
        return np.ascontiguousarray(np.moveaxis(np.moveaxis(
            a.reshape(state_shape + (n_chunks, action_chunk)), -2, 0),
            -1, -2))

    fr_c = [dev_layout(f) for f in fr]
    cost = dev_layout(np.broadcast_to(
        np.asarray(stage_cost, np.float32), q_shape).astype(np.float32))

    return ShearGatherBackup(
        corner_idx=jnp.asarray(corner_idx.astype(np.int32)),
        j_idx=tuple(jnp.asarray(np.ascontiguousarray(
            np.moveaxis(j, -1, -2))) for j in j_idx),
        frac=tuple(jnp.asarray(f) for f in fr_c),
        cost=jnp.asarray(cost),
        win_start=tuple(tuple(int(w) for w in row) for row in win_start),
        grid_shape=plan.grid_shape,
        state_shape=state_shape,
        t_shape=t_shape,
        n_band=n_band,
        upsample=ups,
        chunk=action_chunk,
        n_actions=n_actions,
    )
