"""6-D row/lane backup kernel vs the gather oracle (interpret mode on CPU).

The kernel must reproduce the generic gather backup exactly: multilinear
interpolation with MATLAB extrapolation semantics, factorized stage cost,
flat C-order first-min argmin (Solver_attitude.m:384-411). Sizes here are
small; the at-scale run (11^3 x 10^3 on a GPU) is chip_smoke.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocdp_tpu.models import attitude
from ocdp_tpu.ops.backup import bellman_backup
from ocdp_tpu.ops.pallas_backup6 import (PallasBackup6D,
                                           build_pallas_backup_6d)


def _full_cost(plan, cost_terms):
    return sum(jnp.broadcast_to(t, plan.query_shape) for t in cost_terms)


@pytest.fixture(scope="module")
def small_problem():
    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
    grid, plan, cost = attitude.build_full(cfg)
    return cfg, grid, plan, cost


def test_single_sweep_matches_gather(small_problem):
    _, grid, plan, cost = small_problem
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    v = jax.random.uniform(jax.random.PRNGKey(0), grid.shape, jnp.float32)
    ref = bellman_backup(v, plan, _full_cost(plan, cost))
    out = bk(v)
    np.testing.assert_allclose(np.asarray(out.values), np.asarray(ref.values),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.argmin),
                                  np.asarray(ref.argmin))


def test_multi_sweep_engine_parity(small_problem):
    cfg, _, _, _ = small_problem
    sol_p = attitude.solve_full(cfg, num_sweeps=5, impl="rowlane",
                                interpret=True)
    sol_g = attitude.solve_full(cfg, num_sweeps=5, impl="gather")
    np.testing.assert_allclose(np.asarray(sol_p.result.values),
                               np.asarray(sol_g.result.values),
                               rtol=1e-5, atol=1e-4)
    agree = (np.asarray(sol_p.result.argmin)
             == np.asarray(sol_g.result.argmin)).mean()
    assert agree == 1.0


def test_row_tile_not_dividing_rows(small_problem):
    """NW = 125 with row_tile=16 forces row padding paths."""
    _, grid, plan, cost = small_problem
    bk = build_pallas_backup_6d(plan, cost, row_tile=16, interpret=True)
    v = jax.random.uniform(jax.random.PRNGKey(1), grid.shape, jnp.float32)
    ref = bellman_backup(v, plan, _full_cost(plan, cost))
    out = bk(v)
    np.testing.assert_allclose(np.asarray(out.values), np.asarray(ref.values),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.argmin),
                                  np.asarray(ref.argmin))


def test_min_only_sweep_matches_tracking_values(small_problem):
    """track_argmin=False (min-only sweeps): values BITWISE equal to the
    tracking kernel's (same where-min, argmin select chain dropped),
    argmin output all-zeros."""
    _, grid, plan, cost = small_problem
    v = jax.random.normal(jax.random.PRNGKey(3), grid.shape, jnp.float32)
    ref = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)(v)
    got = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True,
                                 track_argmin=False)(v)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    assert not np.any(np.asarray(got.argmin))


def test_asymmetric_euler_meshes():
    """Unequal Euler axis sizes exercise non-uniform lane strides."""
    cfg = attitude.AttitudeConfig(n_mesh_w=4, n_mesh_q=3)
    grid, plan, cost = attitude.build_full(cfg)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    v = jax.random.uniform(jax.random.PRNGKey(2), grid.shape, jnp.float32)
    ref = bellman_backup(v, plan, _full_cost(plan, cost))
    out = bk(v)
    np.testing.assert_allclose(np.asarray(out.values), np.asarray(ref.values),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.argmin),
                                  np.asarray(ref.argmin))


@pytest.mark.slow
def test_flat_plan_matches_full(small_problem):
    """Flat (rows, lanes, actions) plans — how envelope-scale plans are
    born on-device — must produce the same backup as the d-D broadcast
    form (same values bitwise, same argmin)."""
    cfg, grid, plan, cost = small_problem
    _, plan_f, cost_f = attitude.build_full(cfg, flat=True)
    assert attitude.plan_is_flat(plan_f) and not attitude.plan_is_flat(plan)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    bk_f = build_pallas_backup_6d(plan_f, cost_f, row_tile=8, interpret=True)
    v = jax.random.uniform(jax.random.PRNGKey(5), grid.shape, jnp.float32)
    r, rf = bk(v), bk_f(v)
    np.testing.assert_array_equal(np.asarray(r.values), np.asarray(rf.values))
    np.testing.assert_array_equal(np.asarray(r.argmin), np.asarray(rf.argmin))


@pytest.mark.slow
def test_flat_plan_solve_full_end_to_end(small_problem):
    """solve_full over a flat plan (PlanShape shim + engine) == full plan
    (flat results come back in the flat layout; compare via the host
    views)."""
    cfg, _, _, _ = small_problem
    sol_f = attitude.solve_full(cfg, num_sweeps=4, impl="rowlane",
                                interpret=True, flat=True,
                                carry_padded=False)
    sol = attitude.solve_full(cfg, num_sweeps=4, impl="rowlane",
                              interpret=True, flat=False)
    np.testing.assert_array_equal(sol_f.values_6d(),
                                  np.asarray(sol.result.values))
    np.testing.assert_array_equal(sol_f.argmin_6d(),
                                  np.asarray(sol.result.argmin))


def test_flat_plan_rejects_stencil_impl(small_problem):
    cfg, _, _, _ = small_problem
    with pytest.raises(ValueError, match="rowlane"):
        attitude.solve_full(cfg, num_sweeps=1, impl="stencil", flat=True)


def test_rejects_non_separable_plan():
    """Kirk's 2-D plan has action-dependent queries on every axis — the
    row/lane split must refuse it (callers fall back to stencil/gather)."""
    from ocdp_tpu.models import kirk

    p = kirk.build(kirk.KirkConfig.golden())
    with pytest.raises(ValueError):
        build_pallas_backup_6d(p.plan, p.stage_cost, row_axes=1,
                               interpret=True)


def test_tie_break_first_min():
    """h=0 pins every query exactly on its own grid point (frac = 0 exact),
    so with zero cost all 27 actions tie EXACTLY; the flat argmin must be 0
    everywhere (MATLAB first-minimum, Solver_attitude.m:400-409)."""
    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, h=0.0)
    grid, plan, cost = attitude.build_full(cfg)
    zero_terms = tuple(jnp.zeros_like(t) for t in cost)
    bk = build_pallas_backup_6d(plan, zero_terms, row_tile=8, interpret=True)
    v = jax.random.uniform(jax.random.PRNGKey(3), grid.shape, jnp.float32)
    out = bk(v)
    assert int(np.asarray(out.argmin).max()) == 0
    # values reproduce V up to the Euler->quat->Euler f32 roundtrip (the w
    # queries are exact at h=0; the Euler readback is not bit-exact)
    np.testing.assert_allclose(np.asarray(out.values), np.asarray(v),
                               atol=2e-6)


@pytest.mark.parametrize("block_rows", [None, 80])
def test_chunked_flat_build_matches_oneshot(block_rows):
    """The row-block chunked flat builder (envelope scales; the one-shot
    jit's transients OOM'd 167M cells) produces identical cell indices and
    ~1-ulp fracs vs the one-shot flat build. block_rows=80 forces the
    multi-block loop INCLUDING the overlapping non-dividing tail block
    (216 rows -> blocks at 0, 80, 136) — the code paths the feature exists
    for, which the auto block size only exercises past ~10M cells."""
    cfg = attitude.AttitudeConfig(n_mesh_w=6, n_mesh_q=5)
    _, p1, c1 = attitude.build_full(cfg, flat=True, chunked=False)
    _, p2, c2 = attitude.build_full(cfg, flat=True, chunked=True,
                                    block_rows=block_rows)
    for k in range(6):
        np.testing.assert_array_equal(np.asarray(p1.lo[k]),
                                      np.asarray(p2.lo[k]))
        np.testing.assert_allclose(np.asarray(p1.frac[k]),
                                   np.asarray(p2.frac[k]),
                                   rtol=0, atol=2e-6)
    for a, b in zip(c1, c2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_chunked_build_solve_matches(small_problem):
    """End-to-end: a solve over the chunked-built plan equals the one-shot
    flat build's solve (same kernel path)."""
    cfg, _, _, _ = small_problem
    import ocdp_tpu.models.attitude as att

    orig = att.build_full
    sols = []
    for chunked in (False, True):
        import unittest.mock as mock

        with mock.patch.object(
                att, "build_full",
                lambda c, **kw: orig(c, flat=True, chunked=chunked)):
            sols.append(att.solve_full(cfg, num_sweeps=4, impl="rowlane",
                                       interpret=True))
    np.testing.assert_allclose(np.asarray(sols[0].result.values),
                               np.asarray(sols[1].result.values),
                               rtol=1e-5, atol=1e-4)
    assert (np.asarray(sols[0].result.argmin)
            == np.asarray(sols[1].result.argmin)).mean() > 0.999


def _small_full(nw=7, nq=5):
    from ocdp_tpu.models import attitude

    cfg = attitude.AttitudeConfig(n_mesh_w=nw, n_mesh_q=nq)
    return attitude.build_full(cfg)


def test_narrow_argmin_dtype_bitwise():
    """uint8 kernel argmin output is bitwise the int32 one, values equal."""
    grid, plan, cost = _small_full()
    bk32 = PallasBackup6D(plan, cost, interpret=True)
    bk8 = PallasBackup6D(plan, cost, interpret=True, argmin_dtype=jnp.uint8)
    v = jax.random.normal(jax.random.PRNGKey(1), grid.shape, jnp.float32)
    r32, r8 = bk32(v), bk8(v)
    np.testing.assert_array_equal(np.asarray(r32.values),
                                  np.asarray(r8.values))
    np.testing.assert_array_equal(np.asarray(r32.argmin),
                                  np.asarray(r8.argmin, np.int32))


def test_rowact_and_rowlane_cost_terms_vs_oracle():
    """The EP-enabling coupled cost buckets: row x action enters the argmin
    contraction, row x lane adds after it — both must match the gather
    oracle with the same terms appended."""
    from ocdp_tpu.ops.backup import bellman_backup

    grid, plan, cost = _small_full(nw=5, nq=4)
    nmw, nmq = 5, 4
    rng = np.random.default_rng(3)
    c_ra = jnp.asarray(rng.uniform(0, 2, (nmw, nmw, nmw, 1, 1, 1, 27)),
                       jnp.float32)
    c_rl = jnp.asarray(rng.uniform(0, 2, (nmw,) * 3 + (nmq,) * 3 + (1,)),
                       jnp.float32)
    terms = list(cost) + [c_ra, c_rl]
    bk = PallasBackup6D(plan, terms, interpret=True)
    assert bk.c_rowact_j and bk.c_rowlane_j
    v = jax.random.normal(jax.random.PRNGKey(2), grid.shape, jnp.float32)
    got = bk(v)
    ref = bellman_backup(v, plan, terms)
    scale = max(1.0, float(jnp.max(jnp.abs(ref.values))))
    np.testing.assert_allclose(np.asarray(got.values),
                               np.asarray(ref.values), atol=3e-5 * scale)
    assert (np.asarray(got.argmin) == np.asarray(ref.argmin)).mean() > 0.999


def test_laneact_coupling_rejected():
    grid, plan, cost = _small_full(nw=5, nq=4)
    nmq = 4
    bad = jnp.ones((1, 1, 1, nmq, nmq, nmq, 27), jnp.float32)
    with pytest.raises(ValueError, match="lane and action"):
        PallasBackup6D(plan, list(cost) + [bad], interpret=True)


def test_consume_plan_fast_lane():
    """consume_plan=True end-to-end in the default lane: the
    device-build path runs on CPU via the device_build override; the
    caller's flat-plan lane buffers must be deleted and the result must
    still match the oracle."""
    from ocdp_tpu.models import attitude
    from ocdp_tpu.ops.backup import bellman_backup

    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
    grid, plan, cost = attitude.build_full(cfg, flat=True)
    grid2, plan_ref, cost_ref = attitude.build_full(cfg, flat=False)
    bk = PallasBackup6D(plan, cost, interpret=True, device_build=True,
                        consume_plan=True)
    # the flat plan's LANE buffers (axes 3..5) were consumed
    for k in range(3, 6):
        assert plan.lo[k].is_deleted(), f"lane lo[{k}] not consumed"
        assert plan.frac[k].is_deleted(), f"lane frac[{k}] not consumed"
    v = jax.random.normal(jax.random.PRNGKey(4), grid.shape, jnp.float32)
    got = bk(v)
    ref = bellman_backup(v, plan_ref, cost_ref)
    scale = max(1.0, float(jnp.max(jnp.abs(ref.values))))
    np.testing.assert_allclose(np.asarray(got.values),
                               np.asarray(ref.values), atol=3e-5 * scale)
    assert (np.asarray(got.argmin) == np.asarray(ref.argmin)).mean() > 0.999


def test_carry_padded_bitwise():
    """Padded-carry mode: the scan carry is the kernel's padded table —
    single sweeps AND multi-sweep engine runs must be bitwise the plain
    path (pad blocks zeroed, garbage rows past NW re-zeroed each sweep so
    expansive extrapolation weights cannot compound them to inf)."""
    from ocdp_tpu.engine import value_iteration_finite
    from ocdp_tpu.ops.interp import PlanShape

    grid, plan, cost = _small_full()
    bk0 = PallasBackup6D(plan, cost, interpret=True, argmin_dtype=jnp.uint8)
    bk1 = PallasBackup6D(plan, cost, interpret=True, argmin_dtype=jnp.uint8,
                         carry_padded=True)
    assert bk1.NW < bk1.NWp          # the garbage-row mask is exercised
    v = jax.random.uniform(jax.random.PRNGKey(3), grid.shape, jnp.float32)
    r0, r1 = bk0(v), bk1(v)
    np.testing.assert_array_equal(np.asarray(r0.values),
                                  np.asarray(r1.values))
    np.testing.assert_array_equal(np.asarray(r0.argmin),
                                  np.asarray(r1.argmin))

    ps = PlanShape.of(plan)
    e0 = value_iteration_finite(ps, None, 6, store_policies=False,
                                backup=bk0)
    e1 = value_iteration_finite(ps, None, 6, store_policies=False,
                                backup=bk1)
    np.testing.assert_array_equal(np.asarray(e0.values),
                                  np.asarray(e1.values))
    np.testing.assert_array_equal(np.asarray(e0.argmin),
                                  np.asarray(e1.argmin))


def test_flat_carry_solution_u_tables_state_shaped():
    """Envelope-mode solves (flat plan + padded carry) keep result arrays
    in the flat (rows, lanes) layout — FullSolution.u_tables must still
    come back (3, *state_shape) and match the plain-path decode, or
    rollout_full breaks for every >8M-cell solve."""
    from ocdp_tpu.engine import value_iteration_finite
    from ocdp_tpu.models import attitude
    from ocdp_tpu.ops.interp import PlanShape

    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
    grid, plan, cost = attitude.build_full(cfg, flat=True)
    bk = PallasBackup6D(plan, cost, interpret=True, argmin_dtype=jnp.uint8,
                        carry_padded=True)
    res = value_iteration_finite(PlanShape.of(plan), None, 4,
                                 store_policies=False, backup=bk,
                                 narrow_argmin_result=True)
    assert res.argmin.ndim == 2     # the flat device layout under test
    sol = attitude.FullSolution(cfg, grid, res)
    ut = np.asarray(sol.u_tables)
    assert ut.shape == (3,) + grid.shape
    ref = attitude.solve_full(cfg, num_sweeps=4, impl="rowlane",
                              interpret=True)
    np.testing.assert_array_equal(ut, np.asarray(ref.u_tables))


def test_carry_padded_rejects_probe_window():
    from ocdp_tpu.engine import value_iteration_finite
    from ocdp_tpu.ops.interp import PlanShape

    grid, plan, cost = _small_full(nw=5, nq=4)
    bk = PallasBackup6D(plan, cost, interpret=True, carry_padded=True)
    with pytest.raises(ValueError, match="probe_window"):
        value_iteration_finite(PlanShape.of(plan), None, 2,
                               store_policies=False, backup=bk,
                               probe_window=((0, 2),) * 6)
