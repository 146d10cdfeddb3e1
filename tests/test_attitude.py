"""Attitude model: simplified + full 6-D solves vs oracle, rollouts, PD baseline."""

import numpy as np
import jax.numpy as jnp
import pytest

from ocdp_tpu.models import attitude
from oracle import bellman_backup as oracle_backup

DEG = np.pi / 180.0


def small_cfg(**kw):
    base = dict(n_mesh_w=9, n_mesh_t=11, n_mesh_q=5, T_final=0.25,
                w_min_deg=-50.0, w_max_deg=50.0)
    base.update(kw)
    return attitude.AttitudeConfig(**base)


@pytest.mark.parametrize("impl", ["gather", "stencil", "rowlane"])
def test_simplified_matches_oracle(impl):
    cfg = small_cfg()
    # strict reference parity (the numpy oracle extrapolates like MATLAB)
    sol = attitude.solve_simplified(cfg, num_sweeps=6, impl=impl,
                                    edge="extrapolate",
                                    interpret=impl == "rowlane")
    c_h = 1 + cfg.h / 2 + cfg.h**2 / 6 + cfg.h**3 / 24
    for i in range(3):
        s_w, s_t = sol.axes[i]
        J = cfg.inertia_diag[i]
        w = s_w.astype(np.float64)[:, None, None]
        t = s_t.astype(np.float64)[None, :, None]
        u = cfg.u_vector.astype(np.float64)[None, None, :]
        nxt = np.stack(np.broadcast_arrays(w + cfg.h * u / J,
                                           t + cfg.h * w * c_h), axis=-1)
        cost = cfg.Qw[i] * w**2 + cfg.Qq[i] * t**2 + cfg.R[i] * u**2
        cost = np.broadcast_to(cost, nxt.shape[:-1])
        vv = np.zeros(nxt.shape[:-2])
        for _ in range(6):
            vv, aa = oracle_backup(vv, (s_w, s_t), nxt, cost)
        np.testing.assert_allclose(np.asarray(sol.values[i]), vv,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(sol.u_tables[i]),
                                   cfg.u_vector[aa], atol=1e-6)


@pytest.mark.parametrize("impl", ["gather", "stencil"])
def test_full_6d_matches_oracle(impl):
    cfg = small_cfg(n_mesh_w=4, n_mesh_q=3, w_min_deg=-20.0, w_max_deg=20.0)
    grid, plan, cost = attitude.build_full(cfg)
    sol = attitude.solve_full(cfg, num_sweeps=3, impl=impl)

    # rebuild queries in float64 via the plan itself is circular; instead
    # verify against the oracle using the plan's own query coordinates,
    # reconstructed from (lo, frac) on the axes (independent arithmetic).
    axes = grid.axes
    qs = []
    for k in range(6):
        lo = np.asarray(plan.lo[k])
        fr = np.asarray(plan.frac[k])
        g = axes[k].astype(np.float64)
        q = g[lo] + fr * (g[np.minimum(lo + 1, len(g) - 1)] - g[lo])
        qs.append(np.broadcast_to(q, plan.query_shape))
    nxt = np.stack(qs, axis=-1)
    cost_np = np.zeros(plan.query_shape)
    for term in cost:  # factorized broadcast terms
        cost_np = cost_np + np.asarray(term, np.float64)
    vv = np.zeros(grid.shape)
    for _ in range(3):
        vv, aa = oracle_backup(vv, axes, nxt, cost_np)
    np.testing.assert_allclose(np.asarray(sol.result.values), vv,
                               rtol=1e-4, atol=1e-4)
    agree = (np.asarray(sol.result.argmin) == aa).mean()
    assert agree > 0.995


def test_full_u_tables_decode_chained_argmin():
    # tiny-scale solve: the decode logic (nested-index composition) is
    # scale-independent; the rollout quality test below carries the
    # historical scale in the slow lane
    cfg = small_cfg(n_mesh_w=5, n_mesh_q=4, T_final=30.0)
    sol = attitude.solve_full(cfg, num_sweeps=50, action_chunk=27,
                              weight_mode="onthefly")
    u = np.asarray(sol.u_tables)
    assert u.shape == (3,) + sol.grid.shape
    assert np.isin(np.round(u.astype(np.float64), 4), [-0.11, 0.0, 0.11]).all()


@pytest.mark.slow
def test_rollout_full_damps_attitude():
    """The .asv-history scale (11^3 x 7^3, 1000 sweeps): the nearest-policy
    rollout damps the (5, 10, -9) deg start to within ~half a grid cell.
    Slow lane: the unrolled 6-D stencil's CPU compile alone is ~2 min (a
    shorter solve doesn't help, and coarser grids freeze the start cell
    under the nearest policy)."""
    cfg = small_cfg(n_mesh_w=11, n_mesh_q=7, T_final=30.0)
    sol = attitude.solve_full(cfg, num_sweeps=1000, action_chunk=27,
                              weight_mode="onthefly")
    X, U, ang = attitude.rollout_full(sol, num_stages=4000)
    X, ang = np.asarray(X), np.asarray(ang)
    assert np.all(np.isfinite(X))
    a_end = np.abs(ang[-200:]).mean(axis=0)
    w_end = np.abs(X[-200:, :3]).mean(axis=0)
    assert np.all(a_end < 4 * DEG), a_end / DEG
    assert np.all(w_end < 6 * DEG), w_end / DEG


def test_rollout_simplified_on_real_dynamics():
    cfg = small_cfg(n_mesh_w=31, n_mesh_t=31, T_final=30.0)
    sol = attitude.solve_simplified(cfg, num_sweeps=800)
    X, U = attitude.rollout_simplified_real_dynamics(sol, num_stages=2000)
    X = np.asarray(X)
    assert np.all(np.isfinite(X))
    qn = np.linalg.norm(X[:, 3:7], axis=1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-4)
    # kirk q-vec (attitude error) shrinks
    assert np.linalg.norm(X[-1, 3:6]) < 0.5 * np.linalg.norm(X[0, 3:6])


def test_linear_control_response_baseline():
    cfg = small_cfg()
    X, U, drift = attitude.linear_control_response(cfg, T_final=30.0)
    X = np.asarray(X)
    assert float(drift) < 1e-5
    assert np.linalg.norm(X[-1, 3:6]) < 0.05 * np.linalg.norm(X[0, 3:6])
    assert np.linalg.norm(X[-1, 0:3]) < 1e-2


def test_rollout_simplified_plant_tracks_training_dynamics():
    cfg = small_cfg(n_mesh_w=31, n_mesh_t=31, T_final=30.0)
    sol = attitude.solve_simplified(cfg, num_sweeps=800)
    X, U = attitude.rollout_simplified_plant(sol, num_stages=2000)
    X = np.asarray(X)
    assert X.shape[1:] == (3, 2)
    assert np.all(np.isfinite(X))
    # angles shrink on the plant the policy was trained on
    assert np.all(np.abs(X[-1, :, 1]) < 0.5 * np.maximum(np.abs(X[0, :, 1]), 0.05))
    assert np.isin(np.round(np.abs(np.asarray(U)).astype(np.float64), 4),
                   [0.0, 0.11]).all()


def test_non_integer_stage_count_warns():
    """Reference guard rail: a T_final/h that is not an integer warns and
    ceils (Solver_attitude.m:151-155; Solver_position.m:77-81;
    Solver_pos_att.m:161-165)."""
    import warnings

    from ocdp_tpu.models.attitude import AttitudeConfig
    from ocdp_tpu.models.pos_att import PosAttConfig
    from ocdp_tpu.models.position import PositionConfig

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        AttitudeConfig()
        PositionConfig()
        PosAttConfig()
        assert not w
        cfg = AttitudeConfig(T_final=30.0, h=0.007)
        assert len(w) == 1 and "not an integer" in str(w[0].message)
        assert cfg.n_stage == 4286


def test_rollout_full_flat_matches_nonflat():
    """Big-grid-layout solutions (flat rows x lanes result tables) must
    fly on device WITHOUT 6-D torque tables: the
    flat path's affine locate + scalar argmin gather must reproduce the
    small-grid u_tables/nearest_eval rollout trajectory exactly, and the
    flat u_tables decode must come back as host numpy."""
    cfg = small_cfg(n_mesh_w=5, n_mesh_q=4, T_final=30.0)
    sol_nf = attitude.solve_full(cfg, num_sweeps=50, impl="rowlane",
                                 interpret=True)
    sol_fl = attitude.solve_full(cfg, num_sweeps=50, impl="rowlane",
                                 interpret=True, flat=True,
                                 carry_padded=True)
    assert not sol_nf.is_flat and sol_fl.is_flat
    # same policy either layout
    np.testing.assert_array_equal(sol_fl.argmin_6d(),
                                  np.asarray(sol_nf.result.argmin))
    # u_tables: host numpy decode for flat, equal to the device decode
    u_fl = sol_fl.u_tables
    assert isinstance(u_fl, np.ndarray)
    np.testing.assert_array_equal(u_fl, np.asarray(sol_nf.u_tables))
    x0 = jnp.asarray([0.3, -0.2, 0.25, 0.05, 0.08, -0.06, 0.99],
                     jnp.float32)
    X_nf, U_nf, _ = attitude.rollout_full(sol_nf, x0, num_stages=300)
    X_fl, U_fl, _ = attitude.rollout_full(sol_fl, x0, num_stages=300)
    np.testing.assert_array_equal(np.asarray(U_fl), np.asarray(U_nf))
    np.testing.assert_array_equal(np.asarray(X_fl), np.asarray(X_nf))
    with pytest.raises(ValueError, match="nearest"):
        attitude.rollout_full(sol_fl, x0, method="interp", num_stages=10)


def test_solve_full_segmented_checkpoint_resume(tmp_path):
    """The model-level envelope form: solve_full(segment_size=...) with a
    checkpoint, killed and resumed — bitwise the one-shot solve (flat +
    padded-carry forced small, as the envelope auto modes would pick)."""
    from ocdp_tpu.io import load_values

    cfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
    ref = attitude.solve_full(cfg, num_sweeps=8, impl="rowlane",
                              interpret=True, flat=True)
    ckpt = str(tmp_path / "att6.npz")
    attitude.solve_full(cfg, num_sweeps=5, impl="rowlane", interpret=True,
                        flat=True,
                        segment_size=3, checkpoint_path=ckpt)
    v, sweep, _ = load_values(ckpt)
    assert sweep == 5
    got = attitude.solve_full(cfg, num_sweeps=8, impl="rowlane",
                              interpret=True, flat=True,
                              segment_size=3, init_values=v,
                              start_sweep=sweep)
    np.testing.assert_array_equal(got.values_6d(), ref.values_6d())
    np.testing.assert_array_equal(got.argmin_6d(), ref.argmin_6d())
