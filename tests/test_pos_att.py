"""Pos-att model: thruster pruning, channel solve vs oracle, early stop,
controller persistence, closed-loop rollout."""

import numpy as np
import jax.numpy as jnp
import pytest

from ocdp_tpu.io import load_channel_controller, save_channel_controller
from ocdp_tpu.models import pos_att
from ocdp_tpu.models.thrusters import thruster_combinations
from oracle import bellman_backup as oracle_backup


def small_cfg(**kw):
    base = dict(n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5, T_final=0.25)
    base.update(kw)
    return pos_att.PosAttConfig(**base)


def test_thruster_combinations_pruning():
    F = 0.13
    healthy = thruster_combinations([0, F], [0, F], [0, -F], [0, -F])
    assert healthy.shape == (9, 4)
    # no opposing-pair firings survive
    assert not np.any((healthy[:, 0] > 0) & (healthy[:, 2] < 0))
    assert not np.any((healthy[:, 1] > 0) & (healthy[:, 3] < 0))
    # first combo is all-off (MATLAB enumeration order, f0 fastest)
    assert np.all(healthy[0] == 0)

    failed = thruster_combinations([0.0], [0, F], [0, -F], [0, -F])
    assert failed.shape == (6, 4)
    assert np.all(failed[:, 0] == 0)


@pytest.mark.parametrize("impl", ["gather", "stencil"])
@pytest.mark.parametrize("failure", [False, True])
def test_channel_backup_matches_oracle(impl, failure):
    cfg = small_cfg()
    problem = pos_att.build_channel(cfg, "x", failure=failure)
    ctrl, result = pos_att.solve_channel(cfg, "x", failure=failure, impl=impl,
                                         max_sweeps=5)
    axes = problem.grid.axes
    f = problem.forces.astype(np.float64)
    J = cfg.channel_inertia("x")
    x = axes[0].astype(np.float64)[:, None, None, None, None]
    v = axes[1].astype(np.float64)[None, :, None, None, None]
    t = axes[2].astype(np.float64)[None, None, :, None, None]
    w = axes[3].astype(np.float64)[None, None, None, :, None]
    fsum = f.sum(axis=1)[None, None, None, None, :]
    fmom = (f[:, 0] - f[:, 1] + f[:, 2] - f[:, 3])[None, None, None, None, :]
    nxt = np.stack(np.broadcast_arrays(
        x + cfg.h * v, v + cfg.h * fsum / cfg.mass, t + cfg.h * w,
        w + cfg.h * fmom * cfg.moment_arm / J), axis=-1)
    cost = (cfg.Qx * x**2 + cfg.Qv * v**2 + cfg.Qt * t**2 + cfg.Qw * w**2
            + cfg.R * (f**2).sum(axis=1)[None, None, None, None, :])
    cost = np.broadcast_to(cost, nxt.shape[:-1])
    vv = np.zeros(nxt.shape[:-2])
    for _ in range(5):
        vv, aa = oracle_backup(vv, axes, nxt, cost)
    np.testing.assert_allclose(ctrl.values, vv, rtol=1e-4, atol=1e-5)
    assert (ctrl.argmin == aa).mean() > 0.999


def test_early_stop_triggers_mechanism():
    """With zero stage cost V stays identically 0, so the first 50-sweep
    checksum delta is 0 -> the loop must break at sweep 50 exactly (the
    reference's :268-286 machinery; at default tolerance/horizon the real
    channels run to the sweep cap, matching the reference loop bound)."""
    cfg = small_cfg(T_final=10.0, Qx=0.0, Qv=0.0, Qt=0.0, Qw=0.0, R=0.0)
    _, result = pos_att.solve_channel(cfg, "y")
    assert bool(result.converged)
    # k_s runs 1999 down; first k_s%50==0 check is at k_s=1950 after 50 sweeps
    assert int(result.num_sweeps) == 50


def test_reference_config_runs_to_cap():
    cfg = small_cfg(T_final=1.0)
    _, result = pos_att.solve_channel(cfg, "y")
    assert not bool(result.converged)
    assert int(result.num_sweeps) == cfg.n_stage - 1


def test_controller_roundtrip(tmp_path):
    cfg = small_cfg()
    ctrl, _ = pos_att.solve_channel(cfg, "z", max_sweeps=3)
    p = str(tmp_path / "channel_z.npz")
    save_channel_controller(p, ctrl)
    back = load_channel_controller(p)
    np.testing.assert_array_equal(back.argmin, ctrl.argmin)
    np.testing.assert_array_equal(back.forces, ctrl.forces)
    np.testing.assert_allclose(back.values, ctrl.values)
    pt = (0.05, -0.02, 0.01, 0.001)
    np.testing.assert_allclose(np.asarray(back.thruster_forces(pt)),
                               np.asarray(ctrl.thruster_forces(pt)))


def test_rollout_smoke_and_regulation():
    cfg = small_cfg(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7,
                    T_final=10.0)
    sol = pos_att.solve(cfg, include_failure=False)
    T, X, F_th, FM = pos_att.get_optimal_path(sol, t_final=4.0)
    X = np.asarray(X)
    F = np.asarray(F_th)
    assert np.all(np.isfinite(X))
    assert F.shape[1] == 12
    # thruster forces are only ever 0 or +-0.13
    assert np.isin(np.round(np.abs(F).astype(np.float64), 4), [0.0, 0.13]).all()
    # quaternion stays normalized through the integration
    qn = np.linalg.norm(X[:, 6:10], axis=1)
    assert np.all(np.abs(qn - 1) < 1e-3)
    # position error shrinks from |x0| = 0.1
    assert np.abs(X[-1, 0]) < np.abs(X[0, 0])


def test_rollout_integrator_parity_ode45_vs_rkf45():
    """The reference flies the 13-state closed loop with MATLAB ode45
    (Solver_pos_att.m:504); our default is the matching Dormand-Prince pair.
    RKF45 at tight tolerance must reproduce the same trajectory to
    integration tolerance (VERDICT r2 item 5)."""
    cfg = small_cfg(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7,
                    T_final=10.0)
    sol = pos_att.solve(cfg, include_failure=False)
    _, X_dp, F_dp, _ = pos_att.get_optimal_path(sol, t_final=2.0,
                                                integrator="ode45")
    _, X_rk, F_rk, _ = pos_att.get_optimal_path(sol, t_final=2.0,
                                                integrator="rkf45")
    X_dp, X_rk = np.asarray(X_dp), np.asarray(X_rk)
    assert np.isfinite(X_dp).all() and np.isfinite(X_rk).all()
    # same thruster decisions -> same piecewise vector field; states agree
    # to the looser (MATLAB-default 1e-3) integration tolerance
    np.testing.assert_array_equal(np.asarray(F_dp), np.asarray(F_rk))
    assert np.max(np.abs(X_dp - X_rk)) < 2e-3


def test_rollout_rk4_serving_matches_ode45():
    """The 'rk4' SERVING mode (one fixed 4th-order step per 5 ms stage, no
    adaptive while_loops — the fast receding-horizon replanning path,
    VERDICT r3 item 3) must make the same thruster decisions as the ode45
    parity path and land within integration tolerance of its final state."""
    cfg = small_cfg(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7,
                    T_final=10.0)
    sol = pos_att.solve(cfg, include_failure=False)
    _, X_dp, F_dp, _ = pos_att.get_optimal_path(sol, t_final=2.0,
                                                integrator="ode45")
    _, X_r4, F_r4, _ = pos_att.get_optimal_path(sol, t_final=2.0,
                                                integrator="rk4")
    X_dp, X_r4 = np.asarray(X_dp), np.asarray(X_r4)
    assert np.isfinite(X_r4).all()
    np.testing.assert_array_equal(np.asarray(F_dp), np.asarray(F_r4))
    # final-state delta bounded by the looser pair's tolerance (MATLAB
    # default RelTol=1e-3); one 4th-order step at h=5 ms is ~1e-10 local
    assert np.max(np.abs(X_dp[-1] - X_r4[-1])) < 2e-3
    assert np.max(np.abs(X_dp - X_r4)) < 2e-3


def test_failure_mode_never_fires_thruster0():
    cfg = small_cfg(T_final=10.0)
    sol = pos_att.solve(cfg, include_failure=True)
    T, X, F_th, FM = pos_att.get_optimal_path(sol, t_final=1.0,
                                              use_x_failure=True)
    F = np.asarray(F_th)
    assert np.all(F[:, 0] == 0.0)


def test_solve_channel_pallas_matches_stencil():
    """The row/lane kernel path (rows=(v,w), lanes=(x,t) permutation) must
    agree with the stencil solve; f32 accumulation over the converged loop
    allows rare one-combo flips only."""
    import numpy as np

    from ocdp_tpu.models import pos_att

    cfg = pos_att.PosAttConfig()
    ctrl_p, res_p = pos_att.solve_channel(cfg, "x", impl="rowlane",
                                          interpret=True, max_sweeps=60)
    ctrl_s, res_s = pos_att.solve_channel(cfg, "x", impl="stencil",
                                          max_sweeps=60)
    np.testing.assert_allclose(np.asarray(res_p.values),
                               np.asarray(res_s.values),
                               rtol=1e-5, atol=1e-3)
    assert (np.asarray(res_p.argmin)
            != np.asarray(res_s.argmin)).mean() < 1e-3


def test_receding_horizon_arbitrary_x0():
    """BASELINE config #5 surface: solve once, replan closed loops from
    several arbitrary initial conditions with the same controllers."""
    import numpy as np

    from ocdp_tpu.models import pos_att

    cfg = small_cfg(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7,
                    T_final=10.0)         # reference-size grid runs 144 s
    sol = pos_att.solve(cfg, include_failure=False)
    for dx, pitch in ((-0.05, 2.0), (0.08, -1.5)):
        x0 = np.array(pos_att.default_x0(pitch_deg=pitch))
        x0[0] = dx
        _, (T, X, F_th, FM) = pos_att.receding_horizon(
            x0, sol=sol, t_final=5.0)
        X = np.asarray(X)
        assert np.isfinite(X).all()
        # position error must shrink in closed loop
        assert abs(X[-1, 0]) < abs(x0[0])


def test_policy_lookup_matches_nearest_eval():
    """The fused serving-path lookup (one affine locate + one row gather per
    channel, models/pos_att._lookup_forces) must return exactly the forces
    the per-thruster nearest_eval lookups (io.ChannelController
    .thruster_forces — the reference's 12 'nearest' griddedInterpolants,
    Solver_pos_att.m:432-447) return at random states incl. out-of-grid."""
    cfg = small_cfg(T_final=10.0)
    sol = pos_att.solve(cfg, include_failure=False, max_sweeps=40)
    ctrls = [sol.controllers[ch] for ch in pos_att.CHANNELS]
    lk = pos_att._build_policy_lookup(ctrls)
    rng = np.random.default_rng(3)
    for _ in range(50):
        xb = jnp.asarray(rng.uniform(-0.3, 0.3, 3).astype(np.float32))
        vb = jnp.asarray(rng.uniform(-0.15, 0.15, 3).astype(np.float32))
        t_ang = jnp.asarray(rng.uniform(-0.1, 0.1, 3).astype(np.float32))
        w = jnp.asarray(rng.uniform(-0.05, 0.05, 3).astype(np.float32))
        got = np.asarray(pos_att._lookup_forces(lk, xb, vb, t_ang, w))
        att = pos_att._ATT_IDX
        for i in range(3):
            pt = (xb[i], vb[i], t_ang[att[i]], w[att[i]])
            ref = np.asarray(ctrls[i].thruster_forces(pt))
            np.testing.assert_array_equal(got[i], ref)


def test_rollout_batch_matches_individual():
    """rollout_batch (vmapped serving rollouts) == per-x0 get_optimal_path,
    trajectory for trajectory."""
    cfg = small_cfg(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7,
                    T_final=10.0)
    sol = pos_att.solve(cfg, include_failure=False)
    x0s = []
    for dx, pitch in ((-0.05, 2.0), (0.08, -1.5), (0.02, 0.5)):
        x0 = np.array(pos_att.default_x0(pitch_deg=pitch))
        x0[0] = dx
        x0s.append(x0)
    T_b, X_b, F_b, FM_b = pos_att.rollout_batch(sol, np.stack(x0s),
                                                t_final=2.0)
    assert X_b.shape[0] == 3 and F_b.shape[2] == 12
    for b, x0 in enumerate(x0s):
        T, X, F_th, FM = pos_att.get_optimal_path(
            sol, jnp.asarray(x0, jnp.float32), t_final=2.0,
            integrator="rk4")
        np.testing.assert_allclose(np.asarray(X_b)[b], np.asarray(X),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(F_b)[b], np.asarray(F_th))
