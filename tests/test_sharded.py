"""Sharded backup == single-chip backup, bitwise in f32 (SURVEY.md §4: the
multi-chip test the reference gets for free by being single-process)."""

import jax
import jax.numpy as np_jax
import numpy as np
import pytest
from jax.sharding import Mesh

from ocdp_tpu import value_iteration_finite
from ocdp_tpu.models import kirk
from ocdp_tpu.parallel import value_iteration_finite_sharded


def small_problem(dx=16, du=12):
    return kirk.build(kirk.KirkConfig(N=12, dx=dx, du=du))


def single(problem, n, store):
    return value_iteration_finite(problem.plan, problem.stage_cost, n,
                                  store_policies=store)


@pytest.mark.parametrize("dx,du", [(16, 12), (17, 13)])  # 17/13: padding path
@pytest.mark.parametrize("store", [False, True])
def test_state_sharding_matches_single_chip(dx, du, store):
    problem = small_problem(dx, du)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("s",))
    ref = single(problem, 11, store)
    got = value_iteration_finite_sharded(
        problem.plan, problem.stage_cost, 11, mesh, store_policies=store
    )
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin), np.asarray(ref.argmin))
    if store:
        np.testing.assert_array_equal(np.asarray(got.policies),
                                      np.asarray(ref.policies))


@pytest.mark.parametrize("dx,du", [(16, 12), (18, 13)])
def test_state_plus_action_sharding_matches_single_chip(dx, du):
    problem = small_problem(dx, du)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("s", "a"))
    ref = single(problem, 9, True)
    got = value_iteration_finite_sharded(
        problem.plan, problem.stage_cost, 9, mesh,
        action_axis_name="a", store_policies=True,
    )
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin), np.asarray(ref.argmin))
    np.testing.assert_array_equal(np.asarray(got.policies), np.asarray(ref.policies))


def test_action_tie_break_across_shards():
    """Duplicate optimal actions split across action shards must resolve to
    the FIRST flat index (MATLAB min semantics across the shard boundary)."""
    from ocdp_tpu.ops.interp import build_plan

    axes = (np.linspace(-1, 1, 9, dtype=np.float32),)
    # all actions map every state to the same next state -> V contribution
    # identical; cost = 0 for every action -> every action ties.
    q = np.zeros((9, 8), dtype=np.float32)
    plan = build_plan(axes, (q,))
    cost = np_jax.zeros((9, 8), dtype=np_jax.float32)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("a",))
    # shard only the action axis: use a 2-D mesh with singleton state axis
    mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("s", "a"))
    got = value_iteration_finite_sharded(
        plan, cost, 3, mesh2, action_axis_name="a", store_policies=False
    )
    assert np.all(np.asarray(got.argmin) == 0)


def test_make_mesh_and_halo_engine_compose():
    from ocdp_tpu.parallel import make_mesh, value_iteration_finite_halo
    from ocdp_tpu import value_iteration_finite
    from ocdp_tpu.ops.stencil import build_stencil_backup

    mesh = make_mesh(("s",), devices=jax.devices()[:8])
    assert mesh.shape["s"] == 8
    problem = small_problem(dx=24, du=10)
    sb = build_stencil_backup(problem.plan, problem.stage_cost, action_chunk=10)
    ref = value_iteration_finite(problem.plan, problem.stage_cost, 5, backup=sb)
    got = value_iteration_finite_halo(problem.plan, problem.stage_cost, 5,
                                      mesh, action_chunk=10)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(ref.values))


def test_make_mesh_2d():
    from ocdp_tpu.parallel import make_mesh

    mesh = make_mesh(("s", "a"), (4, 2), devices=jax.devices()[:8])
    assert mesh.shape == {"s": 4, "a": 2}


def test_make_mesh_device_order_contract():
    """Pin the layout claim in make_mesh's docstring: axes follow JAX device
    order with the LAST mesh axis fastest-varying, so blocks of a state axis
    placed last land on consecutive devices (parallel/multihost.py
    docstring)."""
    from ocdp_tpu.parallel import make_mesh

    devs = jax.devices()[:8]
    ids = [d.id for d in devs]
    # 1-D: device order preserved verbatim.
    mesh1 = make_mesh(("s",), devices=devs)
    assert [d.id for d in mesh1.devices.ravel()] == ids

    # 2-D ("h", "s"): along the trailing state axis (fixed h) ids are
    # consecutive; along the leading host axis (fixed s) they stride by
    # the state-axis size.
    mesh = make_mesh(("h", "s"), (2, 4), devices=devs)
    grid = np.vectorize(lambda d: d.id)(mesh.devices)
    for h in range(2):
        row = grid[h, :]
        assert list(np.diff(row)) == [1, 1, 1], row
    assert list(grid[1, :] - grid[0, :]) == [4, 4, 4, 4]
