"""pos-att channel expert-parallelism: 4 channels in one mesh dispatch.

The reference solves x / y / z / x-failure serially
(Solver_pos_att.m:217-240); ``solve_ep`` shards them over a mesh axis.
Round-4 rebuild: each device runs the SAME ``value_iteration_converged``
engine the serial path uses, over the row/lane kernel backup rebuilt
with a union tap structure (one treedef across channels) — so EP must be
bitwise equal to the serial rowlane solves, channel by channel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocdp_tpu.models import pos_att


def small_cfg(**kw):
    return pos_att.PosAttConfig(n_mesh_x=8, n_mesh_v=8, n_mesh_t=6,
                                n_mesh_w=5, **kw)


def _problems(cfg, include_failure=True):
    ps = [pos_att.build_channel(cfg, ch) for ch in ("x", "y", "z")]
    if include_failure:
        ps.append(pos_att.build_channel(cfg, "x", failure=True))
    return ps


def test_union_backups_one_treedef_and_bitwise():
    """The union-structure rebuild must (a) unify all four channels to one
    treedef and (b) leave every channel's backup output bitwise unchanged
    vs its own-structure build (extra taps carry exactly-zero weight)."""
    cfg = small_cfg()
    problems = _problems(cfg)
    bks = pos_att.build_ep_rowlane_backups(cfg, problems, interpret=True)
    assert len({jax.tree_util.tree_structure(b) for b in bks}) == 1
    rng = np.random.default_rng(0)
    for p, uni in zip(problems, bks):
        own = pos_att.build_channel_rowlane_backup(cfg, p, interpret=True)
        v = jnp.asarray(rng.uniform(0, 5, p.grid.shape).astype(np.float32))
        r_own, r_uni = own(v), uni(v)
        np.testing.assert_array_equal(np.asarray(r_own.values),
                                      np.asarray(r_uni.values))
        np.testing.assert_array_equal(np.asarray(r_own.argmin),
                                      np.asarray(r_uni.argmin))


@pytest.mark.parametrize("include_failure",
                         [True, pytest.param(False,
                                             marks=pytest.mark.slow)])
def test_ep_matches_serial(include_failure):
    """EP == serial rowlane solve_channel, bitwise (values AND argmin)."""
    cfg = small_cfg()
    sol, results = pos_att.solve_ep(cfg, include_failure=include_failure,
                                    max_sweeps=25, return_results=True,
                                    interpret=True)
    names = ["x", "y", "z"] + (["x_failure"] if include_failure else [])
    assert set(sol.controllers) == set(names)
    for name in names:
        ctrl_ref, res_ref = pos_att.solve_channel(
            cfg, name.replace("_failure", ""), failure="failure" in name,
            impl="rowlane", interpret=True, max_sweeps=25)
        got = sol.controllers[name]
        np.testing.assert_array_equal(got.values, ctrl_ref.values)
        np.testing.assert_array_equal(got.argmin, ctrl_ref.argmin)
        np.testing.assert_array_equal(got.forces, ctrl_ref.forces)
        assert results[name]["num_sweeps"] == int(res_ref.num_sweeps)
        assert results[name]["converged"] == bool(res_ref.converged)


@pytest.mark.slow
def test_ep_close_to_gather_oracle():
    """The rowlane kernel EP rides differs from the gather oracle only by
    f32 summation order."""
    cfg = small_cfg()
    sol = pos_att.solve_ep(cfg, max_sweeps=30, interpret=True)
    for name in ("x", "y", "z"):
        ctrl_ref, _ = pos_att.solve_channel(cfg, name, impl="gather",
                                            max_sweeps=30)
        np.testing.assert_allclose(sol.controllers[name].values,
                                   ctrl_ref.values, rtol=2e-6, atol=1e-5)
        agree = (sol.controllers[name].argmin == ctrl_ref.argmin).mean()
        assert agree > 0.999


def test_ep_per_channel_early_stop():
    """With a huge tolerance every channel stops at its first check, each
    device's while_loop exiting independently — identical stop sweep and
    tables to the serial early-stopped solves."""
    cfg = small_cfg(tol=1e12, check_every=5)
    sol, results = pos_att.solve_ep(cfg, max_sweeps=20, return_results=True,
                                    interpret=True)
    for name in ("x", "y", "z", "x_failure"):
        ctrl_ref, res_ref = pos_att.solve_channel(
            cfg, name.replace("_failure", ""), failure="failure" in name,
            impl="rowlane", interpret=True, max_sweeps=20)
        assert bool(res_ref.converged)
        assert results[name]["converged"]
        assert results[name]["num_sweeps"] == int(res_ref.num_sweeps)
        got = sol.controllers[name]
        np.testing.assert_array_equal(got.values, ctrl_ref.values)
        np.testing.assert_array_equal(got.argmin, ctrl_ref.argmin)


def test_ep_failure_channel_action_padding():
    """The padded (inf-cost) combos of the 6-action failure channel must
    never be selected."""
    cfg = small_cfg()
    sol = pos_att.solve_ep(cfg, max_sweeps=10, interpret=True)
    n_fail_actions = sol.controllers["x_failure"].forces.shape[0]
    assert n_fail_actions == 6
    assert sol.controllers["x_failure"].argmin.max() < n_fail_actions


def test_live_sets_must_be_superset():
    """A live_sets that misses one of the plan's own live combos fails
    loudly (guards against a stale union)."""
    cfg = small_cfg()
    p = pos_att.build_channel(cfg, "y")   # widest row reach (+-2)
    own = pos_att.build_channel_rowlane_backup(cfg, p, interpret=True).bk
    bad = (own.w_taps, own.row_combos[:-1], own.e_taps, own.lane_combos)
    with pytest.raises(ValueError, match="do not cover"):
        pos_att.build_channel_rowlane_backup(cfg, p, live_sets=bad,
                                             interpret=True)


def test_solve_unified_single_program_matches_serial():
    """pos_att.solve(impl='rowlane') routes every channel through ONE
    jitted program over the union-treedef backups (one kernel compile for
    x, y, z, x-failure); results must stay bitwise equal to the
    per-channel solve_channel builds."""
    cfg = small_cfg()
    sol = pos_att.solve(cfg, impl="rowlane", interpret=True, max_sweeps=25)
    assert set(sol.controllers) == {"x", "y", "z", "x_failure"}
    for name in ("x", "y", "z", "x_failure"):
        ctrl_ref, _ = pos_att.solve_channel(
            cfg, name.replace("_failure", ""), failure="failure" in name,
            impl="rowlane", interpret=True, max_sweeps=25)
        got = sol.controllers[name]
        np.testing.assert_array_equal(got.values, ctrl_ref.values)
        np.testing.assert_array_equal(got.argmin, ctrl_ref.argmin)
        np.testing.assert_array_equal(got.forces, ctrl_ref.forces)


def test_solve_unified_compiles_once():
    """The whole point of the unified path: 4 channels, ONE compilation of
    the converged engine."""
    cfg = small_cfg()
    problems = _problems(cfg)
    bks = pos_att.build_ep_rowlane_backups(cfg, problems, interpret=True)
    from functools import partial

    from ocdp_tpu.engine import value_iteration_converged
    from ocdp_tpu.ops.interp import PlanShape

    plan_shape = PlanShape.of(problems[0].plan)
    n_traces = 0

    @partial(jax.jit, static_argnames=("n",))
    def run(bk, n):
        nonlocal n_traces
        n_traces += 1
        return value_iteration_converged(plan_shape, None, n, check_every=5,
                                         tol=cfg.tol, backup=bk)

    for bk in bks:
        jax.block_until_ready(run(bk, 10).values)
    assert n_traces == 1


def test_sharded_channel_solve_matches_serial():
    """solve_channel_sharded (halo + replicated engines) == the single-chip
    early-stopping channel solve — the high-res scaling path of
    BASELINE.json configs #4/#5."""
    from jax.sharding import Mesh

    cfg = pos_att.PosAttConfig(n_mesh_x=16, n_mesh_v=8, n_mesh_t=6,
                               n_mesh_w=5)
    ref_ctrl, ref_res = pos_att.solve_channel(cfg, "x", max_sweeps=30)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("s",))
    # halo shares the serial solve's stencil backup -> bitwise; replicated
    # uses the gather backup -> f32 summation-order differences only
    for engine, atol in (("halo", 0.0), ("replicated", 1e-4)):
        ctrl, res = pos_att.solve_channel_sharded(cfg, "x", mesh,
                                                  max_sweeps=30,
                                                  engine=engine)
        np.testing.assert_allclose(ctrl.values, ref_ctrl.values, atol=atol)
        agree = (ctrl.argmin == ref_ctrl.argmin).mean()
        assert agree > 0.999, engine
        assert int(res.num_sweeps) == int(ref_res.num_sweeps)
