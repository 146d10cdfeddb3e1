"""Segmented solve: streaming policies, checkpoints, resume == one-shot."""

import numpy as np

from ocdp_tpu import value_iteration_finite
from ocdp_tpu.engine import value_iteration_segmented
from ocdp_tpu.io import load_values
from ocdp_tpu.models import kirk


def test_segmented_matches_oneshot_with_streamed_policies():
    p = kirk.build(kirk.KirkConfig(N=14, dx=12, du=9))
    ref = value_iteration_finite(p.plan, p.stage_cost, 13, store_policies=True)
    got = value_iteration_segmented(p.plan, p.stage_cost, 13, segment_size=5,
                                    store_policies=True)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin), np.asarray(ref.argmin))
    assert isinstance(got.policies, np.ndarray)  # host-resident
    np.testing.assert_array_equal(got.policies, np.asarray(ref.policies))


def test_checkpoint_and_resume(tmp_path):
    p = kirk.build(kirk.KirkConfig(N=14, dx=12, du=9))
    ckpt = str(tmp_path / "vi.npz")
    seen = []
    ref = value_iteration_finite(p.plan, p.stage_cost, 12)

    # run 7 of 12 sweeps, checkpointing
    value_iteration_segmented(p.plan, p.stage_cost, 7, segment_size=4,
                              checkpoint_path=ckpt,
                              checkpoint_axes=p.grid.axes,
                              on_segment=lambda k, v: seen.append(k))
    assert seen == [4, 7]
    v, sweep, axes = load_values(ckpt)
    assert sweep == 7 and len(axes) == 2

    # resume the remaining 5
    got = value_iteration_segmented(p.plan, p.stage_cost, 12, segment_size=4,
                                    init_values=v, start_sweep=sweep)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin), np.asarray(ref.argmin))


def _envelope_backup(cfg):
    """A padded-carry (envelope-mode) 6-D kernel on a flat plan + the
    PlanShape stand-in — exactly what solve_full builds past 8M cells."""
    from ocdp_tpu.models import attitude
    from ocdp_tpu.ops.interp import PlanShape
    from ocdp_tpu.ops.pallas_backup6 import build_pallas_backup_6d

    grid, plan, cost = attitude.build_full(cfg, flat=True)
    bk = build_pallas_backup_6d(plan, cost, carry_padded=True,
                                argmin_dtype=np.uint8, interpret=True)
    return grid, PlanShape.of(plan), bk


def test_segmented_padded_carry_matches_oneshot():
    """The envelope engine mode (padded-carry scan, flat results) must be
    segmentable BITWISE: pads are zeros at every segment start and after
    every in-kernel sweep, and real cells never read pad lanes (VERDICT r4
    item 3 — checkpoint/resume at the scales where it matters)."""
    import jax

    from ocdp_tpu.models import attitude

    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, T_final=30.0,
                                  w_min_deg=-50.0, w_max_deg=50.0)
    grid, plan_shape, bk = _envelope_backup(cfg)
    ref = jax.jit(lambda: value_iteration_finite(
        plan_shape, None, 9, backup=bk, narrow_argmin_result=True))()
    got = value_iteration_segmented(plan_shape, None, 9, segment_size=4,
                                    backup=bk, narrow_argmin_result=True)
    assert got.values.shape == ref.values.shape    # flat (rows, lanes)
    assert got.argmin.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))


def test_segmented_padded_carry_kill_and_resume(tmp_path):
    """Kill-and-resume on the envelope mode: checkpoint the flat table
    mid-solve, resume from the npz in a FRESH segmented call, land bitwise
    on the uninterrupted result."""
    import jax

    from ocdp_tpu.models import attitude

    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, T_final=30.0,
                                  w_min_deg=-50.0, w_max_deg=50.0)
    grid, plan_shape, bk = _envelope_backup(cfg)
    ref = jax.jit(lambda: value_iteration_finite(
        plan_shape, None, 11, backup=bk, narrow_argmin_result=True))()
    ckpt = str(tmp_path / "envelope.npz")
    value_iteration_segmented(plan_shape, None, 6, segment_size=3,
                              backup=bk, checkpoint_path=ckpt,
                              checkpoint_axes=grid.axes)   # "killed" here
    v, sweep, axes = load_values(ckpt)
    assert sweep == 6 and v.shape == ref.values.shape and len(axes) == 6
    got = value_iteration_segmented(plan_shape, None, 11, segment_size=3,
                                    backup=bk, init_values=v,
                                    start_sweep=sweep,
                                    narrow_argmin_result=True)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))


def test_segmented_padded_carry_rejects_policy_store():
    import pytest

    from ocdp_tpu.models import attitude

    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, T_final=30.0,
                                  w_min_deg=-50.0, w_max_deg=50.0)
    _, plan_shape, bk = _envelope_backup(cfg)
    with pytest.raises(ValueError, match="store_policies"):
        value_iteration_segmented(plan_shape, None, 4, backup=bk,
                                  store_policies=True)


def test_segmented_tol_stop_matches_converged_engine():
    """Host-side early stop at segment boundaries: with segment_size ==
    check_every the stop DECISION (sweep count) and the stopped-at values
    match the converged engine's in-loop rule."""
    from ocdp_tpu.engine import value_iteration_converged
    from ocdp_tpu.models import pos_att

    cfg = pos_att.PosAttConfig(n_mesh_x=8, n_mesh_v=8, n_mesh_t=6,
                               n_mesh_w=5, T_final=2.0)
    p = pos_att.build_channel(cfg, "x")
    ref = value_iteration_converged(p.plan, p.stage_cost, 1000,
                                    check_every=20, tol=2e-2,
                                    tol_mode="rel")
    got = value_iteration_segmented(p.plan, p.stage_cost, 1000,
                                    segment_size=20, tol=2e-2,
                                    tol_mode="rel")
    assert bool(ref.converged) and bool(got.converged)
    assert int(got.num_sweeps) == int(ref.num_sweeps)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))


def test_segmented_tol_stop_padded_carry():
    """tol + padded-carry: the envelope checkpoint/early-stop combination
    the multi-hour nominal solve runs. Flat zeros-padded layouts make the
    plain sum the masked sum, so the decision matches a converged run of
    the same backup."""
    from ocdp_tpu.models import attitude

    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4, T_final=1.5)
    grid, ps, bk = _envelope_backup(cfg)
    got = value_iteration_segmented(ps, None, 300, segment_size=50,
                                    backup=bk, tol=1e-3, tol_mode="rel")
    ref_n = None
    from ocdp_tpu.engine import value_iteration_converged

    ref = value_iteration_converged(ps, None, 300, check_every=50,
                                    tol=1e-3, tol_mode="rel", backup=bk)
    assert bool(got.converged) == bool(ref.converged)
    assert int(got.num_sweeps) == int(ref.num_sweeps)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
