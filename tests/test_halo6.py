"""Row-sharded 6-D halo engine (parallel/halo6.py) vs the single-device
row/lane kernel: bitwise parity, halo-width guard, policy stacks.

The multi-device scaling path for the flagship full-attitude solve
(attitude-control/Solver_attitude.m:261-300) past one device's memory.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from ocdp_tpu.engine import value_iteration_finite
from ocdp_tpu.models import attitude
from ocdp_tpu.ops.pallas_backup6 import build_pallas_backup_6d
from ocdp_tpu.parallel import value_iteration_finite_halo6


def _problem(nw, nq):
    cfg = attitude.AttitudeConfig(n_mesh_w=nw, n_mesh_q=nq)
    return attitude.build_full(cfg)


@pytest.mark.slow
def test_halo6_matches_single_chip_bitwise():
    grid, plan, cost = _problem(5, 4)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    ref = jax.jit(lambda p_, c_, b: value_iteration_finite(
        p_, c_, 6, store_policies=True, backup=b))(plan, cost, bk)
    mesh = Mesh(np.array(jax.devices()[:2]), ("s",))
    got = value_iteration_finite_halo6(plan, cost, 6, mesh, row_tile=8,
                                       store_policies=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))
    np.testing.assert_array_equal(np.asarray(got.policies),
                                  np.asarray(ref.policies))
    assert got.policies.dtype == np.uint8    # 27 actions -> narrow store


@pytest.mark.slow
def test_halo6_four_devices():
    grid, plan, cost = _problem(7, 4)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    ref = jax.jit(lambda p_, c_, b: value_iteration_finite(
        p_, c_, 4, store_policies=False, backup=b))(plan, cost, bk)
    mesh = Mesh(np.array(jax.devices()[:4]), ("s",))
    got = value_iteration_finite_halo6(plan, cost, 4, mesh, row_tile=8,
                                       interpret=True)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))


def test_halo6_width_guard():
    """Reach spanning past the immediate neighbor must raise, not corrupt:
    125 rows over 8 devices leaves 16-row blocks, the row taps reach 31."""
    grid, plan, cost = _problem(5, 4)
    mesh = Mesh(np.array(jax.devices()[:8]), ("s",))
    with pytest.raises(ValueError, match="halo widths"):
        value_iteration_finite_halo6(plan, cost, 2, mesh, row_tile=8,
                                     interpret=True)


@pytest.mark.slow
def test_halo6_converged_matches_single_chip():
    """Early-stopping twin: identical stop decision + bitwise values vs the
    single-chip converged engine running the same 6-D kernel."""
    from ocdp_tpu.engine import value_iteration_converged
    from ocdp_tpu.parallel import value_iteration_converged_halo6

    grid, plan, cost = _problem(5, 4)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    ref = jax.jit(lambda p_, c_, b: value_iteration_converged(
        p_, c_, 11, check_every=3, tol=1e6, backup=b))(plan, cost, bk)
    mesh = Mesh(np.array(jax.devices()[:2]), ("s",))
    got = value_iteration_converged_halo6(plan, cost, 11, mesh,
                                          check_every=3, tol=1e6,
                                          row_tile=8, interpret=True)
    # a huge tol stops both at the FIRST check (k_s=9, after 3 sweeps)
    assert int(ref.num_sweeps) == int(got.num_sweeps) == 3
    assert bool(got.converged)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))
    # checksums equal up to shard reduction order
    np.testing.assert_allclose(np.asarray(got.checks[0]),
                               np.asarray(ref.checks[0]), rtol=1e-6)


def test_halo6_converged_runs_to_cap_without_stop():
    """tol=0 never fires: the loop runs to max_sweeps and matches the
    finite engine bitwise (same sweeps, no early exit)."""
    from ocdp_tpu.parallel import value_iteration_converged_halo6

    grid, plan, cost = _problem(5, 4)
    mesh = Mesh(np.array(jax.devices()[:2]), ("s",))
    fin = value_iteration_finite_halo6(plan, cost, 6, mesh, row_tile=8,
                                       interpret=True)
    got = value_iteration_converged_halo6(plan, cost, 6, mesh,
                                          check_every=2, tol=0.0,
                                          row_tile=8, interpret=True)
    assert not bool(got.converged)
    assert int(got.num_sweeps) == 6
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(fin.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(fin.argmin))


@pytest.mark.slow
def test_halo6_2d_mesh_action_axis_bitwise():
    """CP x TP composition (VERDICT r3 item 6): rows sharded over 's' AND
    the 27-action contraction sharded over 'a' (3 groups of 9, rebuilt
    with the union tap structure) — values AND argmin bitwise vs the
    single-chip kernel (ascending-offset first-min combine)."""
    grid, plan, cost = _problem(5, 4)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    ref = jax.jit(lambda p_, c_, b: value_iteration_finite(
        p_, c_, 5, store_policies=False, backup=b))(plan, cost, bk)
    mesh = Mesh(np.array(jax.devices()[:6]).reshape(2, 3), ("s", "a"))
    got = value_iteration_finite_halo6(plan, cost, 5, mesh, row_tile=8,
                                       action_axis_name="a", interpret=True)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))


@pytest.mark.slow
def test_halo6_2d_mesh_converged_matches_single_chip():
    """Early-stopping engine on the 2-D mesh: identical stop sweep and
    bitwise tables vs the single-chip converged solve."""
    from ocdp_tpu.engine import value_iteration_converged
    from ocdp_tpu.parallel import value_iteration_converged_halo6

    grid, plan, cost = _problem(5, 4)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    ref = jax.jit(lambda p_, c_, b: value_iteration_converged(
        p_, c_, 12, check_every=3, tol=1e12, backup=b))(plan, cost, bk)
    assert bool(ref.converged)
    mesh = Mesh(np.array(jax.devices()[:6]).reshape(2, 3), ("s", "a"))
    got = value_iteration_converged_halo6(plan, cost, 12, mesh, row_tile=8,
                                          check_every=3, tol=1e12,
                                          action_axis_name="a", interpret=True)
    assert bool(got.converged)
    assert int(got.num_sweeps) == int(ref.num_sweeps)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))


def test_halo6_action_axis_indivisible_rejected():
    grid, plan, cost = _problem(5, 4)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("s", "a"))
    with pytest.raises(ValueError, match="do not split"):
        value_iteration_finite_halo6(plan, cost, 2, mesh, row_tile=8,
                                     action_axis_name="a", interpret=True)


def test_halo6_rejects_carry_padded():
    grid, plan, cost = _problem(5, 4)
    mesh = Mesh(np.array(jax.devices()[:2]), ("s",))
    with pytest.raises(ValueError, match="carry_padded"):
        value_iteration_finite_halo6(plan, cost, 2, mesh, row_tile=8,
                                     carry_padded=True, interpret=True)


@pytest.mark.slow
def test_halo6_grid_beyond_one_device_budget():
    """The 8-way mesh solving a grid whose flat table busts a per-device
    budget — the reason halo6 exists (the reference's nominal 90x50 grid
    "can't be run on my 8GB of RAM", Solver_attitude.m:185-192).

    15^3 x 12^3 = 5.83M cells: the padded flat f32 value table is ~24 MB.
    Take a simulated per-device budget of 8 MB (a scaled stand-in for one
    chip's HBM): the FULL table exceeds it 3x, while each of the 8 devices
    holds only its row block + two halo slabs — comfortably inside. The
    sharded solve must still be BITWISE the single-device kernel's (which
    CAN run here because host RAM plays the role of an oversized chip —
    exactly how this property is testable at all).
    """
    from ocdp_tpu.parallel.halo6 import _build_rowsharded

    grid, plan, cost = _problem(15, 12)
    n_dev = 8
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("s",))

    # per-device residency accounting (CPU backend exposes no device
    # memory stats; the block geometry is the evidence)
    bk_s, B, lo, hi = _build_rowsharded(plan, cost, n_dev,
                                        {"row_tile": 8, "interpret": True})
    budget = 8 * 2**20
    full_table = bk_s.NWp * bk_s.NEp * 4
    block_table = (B + lo + hi) * bk_s.NEp * 4       # f32 V block + halos
    block_argmin = B * bk_s.NEp                      # uint8 argmin block
    assert full_table > budget, (full_table, budget)
    # block + halos + argmin ~7.3 MB: inside the budget the full 24 MB
    # table busts. (The halo fraction is large at this toy height — ~490
    # of 912 block rows — because row taps reach +-nw^2 rows; at envelope
    # heights (50^3 rows) the same absolute halo is ~1% of the block.)
    assert block_table + block_argmin < budget, (block_table, budget)

    got = value_iteration_finite_halo6(plan, cost, 2, mesh, row_tile=8,
                                       interpret=True)
    bk = build_pallas_backup_6d(plan, cost, row_tile=8, interpret=True)
    ref = jax.jit(lambda b: value_iteration_finite(
        plan, cost, 2, store_policies=False, backup=b))(bk)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))
