"""Randomized 4-D row/lane-kernel agreement fuzz.

A separable lane lerp applied to lane-coupled queries is 8e-4 off the
oracle — a bug class only a 4-D/6-D check catches, not the (2-D-only)
fuzz suite. This fuzz sweeps random
pos-att-class 4-D problems (Solver_pos_att.m:299-328's structure: two
action-coupled row axes, two drift lane axes) through the float64 brute-
force oracle, the XLA stencil, and :class:`PermutedRowLaneBackup` — BOTH
with separable lane queries (x' = f(x, rows), t' = f(t, rows)) and with
DELIBERATELY lane-coupled queries (x' also depends on t) — and asserts:

* values agree with the float64 oracle to 2e-6 * scale (far below the
  8e-4 bug-class signature, and tighter than the 1e-5 the verdict asked);
* a coupled plan is served exactly (the kernel accumulates joint lane
  combos for every plan).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from ocdp_tpu.grids import Grid, linspace_axis
from ocdp_tpu.ops.interp import build_plan
from ocdp_tpu.ops.pallas_backup6 import PermutedRowLaneBackup
from ocdp_tpu.ops.stencil import build_stencil_backup


def _random_4d_problem(rng, couple_lanes):
    """Random (x, v, theta, omega) x thruster-class problem.

    Row axes after the (v, w, x, t) permutation: v' = v + h f/m and
    w' = w + h m_u/J (action-coupled, own-axis only). Lane axes:
    x' = x + h v and t' = t + h w — plus, when ``couple_lanes``, a cross
    term making x' depend on t (the coupling class the separable lerp
    must NOT be applied to).
    """
    nx = int(rng.integers(5, 9))
    nv = int(rng.integers(5, 9))
    nt = int(rng.integers(4, 8))
    nw = int(rng.integers(4, 7))
    h = float(rng.uniform(0.005, 0.05))
    mass = float(rng.uniform(1.0, 8.0))
    J = float(rng.uniform(0.01, 0.1))
    arm = float(rng.uniform(0.05, 0.2))
    n_u = int(rng.integers(2, 5))
    f_sum = rng.uniform(-0.5, 0.5, n_u).astype(np.float32)
    f_mom = rng.uniform(-0.5, 0.5, n_u).astype(np.float32)

    s_x = linspace_axis(-float(rng.uniform(0.2, 1.0)), 0.7, nx)
    s_v = linspace_axis(-0.4, float(rng.uniform(0.2, 0.8)), nv)
    s_t = linspace_axis(-0.3, 0.3, nt)
    s_w = linspace_axis(-0.5, 0.5, nw)
    grid = Grid((s_x, s_v, s_t, s_w))

    x = jnp.asarray(s_x)[:, None, None, None, None]
    v = jnp.asarray(s_v)[None, :, None, None, None]
    t = jnp.asarray(s_t)[None, None, :, None, None]
    w = jnp.asarray(s_w)[None, None, None, :, None]
    fs = jnp.asarray(f_sum)[None, None, None, None, :]
    fm = jnp.asarray(f_mom)[None, None, None, None, :]

    # NOTE: the cross term must be structurally absent in the separable
    # case — a 0.0 * t addend still broadcasts the query along t, and the
    # (shape-based) separability detector rightly treats that as coupled
    x_next = x + h * v
    if couple_lanes:
        x_next = x_next + float(rng.uniform(0.3, 1.2)) * t
    v_next = v + h * fs / mass
    t_next = t + h * w
    w_next = w + h * fm * arm / J
    plan = build_plan(grid.axes, (x_next, v_next, t_next, w_next))

    qx, qv, qt, qw, r = rng.uniform(0.1, 8.0, 5)
    terms = [qx * x**2, qv * v**2, qt * t**2, qw * w**2,
             r * (fs**2 + fm**2)]
    nexts = np.stack(np.broadcast_arrays(
        *(np.asarray(a, np.float64)
          for a in (x_next, v_next, t_next, w_next))), axis=-1)
    cost64 = np.zeros(plan.query_shape, np.float64)
    for tm in terms:
        cost64 = cost64 + np.asarray(tm, np.float64)
    return grid, plan, terms, nexts, cost64


@pytest.mark.parametrize("seed", [pytest.param(i, marks=pytest.mark.slow)
                                  if i >= 3 else i for i in range(6)])
@pytest.mark.parametrize("couple_lanes", [False, True])
def test_random_4d_rowlane_vs_float64_oracle(seed, couple_lanes):
    rng = np.random.default_rng(1000 + seed)
    grid, plan, terms, nexts, cost64 = _random_4d_problem(rng, couple_lanes)
    v = rng.uniform(0.0, 5.0, plan.grid_shape).astype(np.float32)

    ref_v, ref_a = oracle.bellman_backup(
        np.asarray(v, np.float64), [np.asarray(a, np.float64)
                                    for a in grid.axes], nexts, cost64)
    scale = max(1.0, float(np.abs(ref_v).max()))

    bk = PermutedRowLaneBackup(plan, terms, perm=(1, 3, 0, 2), row_axes=2,
                               interpret=True)
    out = bk(jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(out.values), ref_v,
                               atol=2e-6 * scale)
    agree = (np.asarray(out.argmin) == ref_a).mean()
    assert agree > 0.99, f"rowlane argmin agreement {agree}"

    cost32 = jnp.asarray(cost64, jnp.float32)
    sb = build_stencil_backup(plan, jnp.broadcast_to(cost32,
                                                     plan.query_shape))
    out_s = sb(jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(out_s.values), ref_v,
                               atol=2e-6 * scale)
    assert (np.asarray(out_s.argmin) == ref_a).mean() > 0.99
