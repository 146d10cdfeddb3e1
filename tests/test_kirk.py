"""Kirk ch.3 regulator end-to-end tests (golden parity problem).

JAX-build analog of the reference's quality gates (SURVEY.md §4):
* small-config solve cross-checked against the brute-force numpy DP oracle,
* the golden-run configuration (test/obj_1.txt: N=130, dx=35, du=100) rollout
  from X0=[2;1] must regulate the state to the origin with bounded controls —
  the behavior shown in Kirk Fig. 3-9(b) (test/target-obj_1.png).
"""

import numpy as np
import pytest

from ocdp_tpu.models import kirk
from oracle import bellman_backup as np_backup


def test_small_kirk_matches_oracle():
    cfg = kirk.KirkConfig(N=4, dx=9, du=7)
    problem = kirk.build(cfg)
    sol = kirk.solve(cfg)

    # oracle replication
    axes = problem.grid.axes
    mesh = np.meshgrid(*[np.asarray(a, np.float64) for a in axes], indexing="ij")
    u = np.asarray(problem.u_mesh, np.float64)
    (a11, a12), (a21, a22) = cfg.A
    b1, b2 = cfg.B
    nxt = np.empty((cfg.dx, cfg.dx, cfg.du, 2))
    nxt[..., 0] = a11 * mesh[0][..., None] + a12 * mesh[1][..., None] + b1 * u
    nxt[..., 1] = a21 * mesh[0][..., None] + a22 * mesh[1][..., None] + b2 * u
    cost = cfg.Q[0] * mesh[0][..., None] ** 2 + cfg.Q[1] * mesh[1][..., None] ** 2 + cfg.R * u**2

    v = np.zeros((cfg.dx, cfg.dx))
    pols = []
    for _ in range(cfg.N - 1):
        v, a = np_backup(v, axes, nxt, cost)
        pols.append(a)

    np.testing.assert_allclose(np.asarray(sol.result.values), v, rtol=1e-3, atol=1e-3)
    # compare u* values (indices may differ on fp ties; values must agree)
    got_u = np.asarray(sol.u_star)  # (N-1, dx, dx), forward-stage layout
    want_u = u[np.stack(pols[::-1])]
    np.testing.assert_allclose(got_u, want_u, atol=1e-6 + np.ptp(u) * 2e-3)


def test_golden_config_rollout_regulates():
    cfg = kirk.KirkConfig.golden()
    assert (cfg.N, cfg.dx, cfg.du) == (130, 35, 100)
    sol = kirk.solve(cfg)
    X, U = kirk.optimal_path(sol, (2.0, 1.0))
    X = np.asarray(X)
    U = np.asarray(U)
    assert X.shape == (cfg.N, 2) and U.shape == (cfg.N - 1,)
    # regulator drives the state near the origin and keeps it there
    assert np.all(np.abs(X[-10:]) < 0.15)
    # controls stay in the admissible range (policy interpolation cannot exceed it)
    assert U.min() >= cfg.u_min - 1e-3 and U.max() <= cfg.u_max + 1e-3
    assert np.all(np.isfinite(X)) and np.all(np.isfinite(U))

    # analytic cross-check: for this config the control bounds are inactive
    # along the optimal path, so the DP solution must track the exact
    # finite-horizon discrete LQR (Riccati recursion) up to grid resolution.
    A = np.asarray(cfg.A)
    B = np.asarray(cfg.B).reshape(2, 1)
    Q = np.diag(cfg.Q)
    R = np.array([[cfg.R]])
    P = np.zeros((2, 2))
    gains = []
    for _ in range(cfg.N - 1):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        gains.append(K)
        P = Q + A.T @ P @ A - A.T @ P @ B @ K
    x = np.array([2.0, 1.0])
    X_lqr, U_lqr = [x], []
    for k in range(cfg.N - 1):
        u = (-gains[cfg.N - 2 - k] @ x).item()
        U_lqr.append(u)
        x = A @ x + (B * u).ravel()
        X_lqr.append(x)
    X_lqr = np.array(X_lqr)
    U_lqr = np.array(U_lqr)
    # control-grid spacing is ~0.5 for the golden config; allow a few cells
    np.testing.assert_allclose(U[:40], U_lqr[:40], atol=1.0)
    np.testing.assert_allclose(X[:40], X_lqr[:40], atol=0.15)


def test_ssu_mode_replays_fixed_stage_policy():
    cfg = kirk.KirkConfig(N=12, dx=15, du=21)
    sol = kirk.solve(cfg)
    X, U = kirk.optimal_path(sol, (1.0, -0.5), mode="ssu", ssu_num=0)
    assert np.all(np.isfinite(np.asarray(X)))
    assert np.asarray(U).shape == (cfg.N - 1,)


def _np_bilinear(table, axes, x1, x2):
    """Numpy twin of the rollout's linear policy interpolation (unclamped
    frac = MATLAB griddedInterpolant extrapolation)."""
    out = []
    for ax, q in ((axes[0], x1), (axes[1], x2)):
        g = np.asarray(ax, np.float64)
        lo = int(np.clip(np.searchsorted(g, q, side="right") - 1, 0,
                         len(g) - 2))
        f = (q - g[lo]) / (g[lo + 1] - g[lo])
        out.append((lo, f))
    (l1, f1), (l2, f2) = out
    t = np.asarray(table, np.float64)
    return ((1 - f1) * (1 - f2) * t[l1, l2] + (1 - f1) * f2 * t[l1, l2 + 1]
            + f1 * (1 - f2) * t[l1 + 1, l2] + f1 * f2 * t[l1 + 1, l2 + 1])


def _oracle_rollout(sol, x0, tables):
    """Exact numpy replication of kirk.optimal_path's scan."""
    cfg = sol.problem.config
    axes = sol.problem.grid.axes
    A = np.asarray(cfg.A)
    B = np.asarray(cfg.B)
    x = np.asarray(x0, np.float64)
    X, U = [x], []
    for table in tables:
        u = _np_bilinear(table, axes, x[0], x[1])
        U.append(u)
        x = A @ x + B * u
        X.append(x)
    return np.array(X), np.array(U)


def test_rollout_matches_oracle_trajectory():
    """Trajectory-level oracle check (not just 'didn't blow up'): the scan
    rollout must equal a step-by-step numpy replay of policy interpolation
    + exact LTI steps (test/Dynamic_Solver.m:126-145)."""
    cfg = kirk.KirkConfig(N=20, dx=21, du=15)
    sol = kirk.solve(cfg)
    tables = np.asarray(sol.u_star, np.float64)
    X, U = kirk.optimal_path(sol, (1.5, -0.75))
    X_ref, U_ref = _oracle_rollout(sol, (1.5, -0.75), tables)
    np.testing.assert_allclose(np.asarray(U), U_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(X), X_ref, rtol=1e-4, atol=1e-4)


def test_ssu_rollout_matches_oracle():
    """'ssu' mode must replay the FIXED stage-ssu_num table at every step
    (test/Dynamic_Solver.m:127-131), verified against the numpy replay."""
    cfg = kirk.KirkConfig(N=12, dx=15, du=21)
    sol = kirk.solve(cfg)
    k = 3
    fixed = np.asarray(sol.u_star, np.float64)[k]
    X, U = kirk.optimal_path(sol, (1.0, -0.5), mode="ssu", ssu_num=k)
    X_ref, U_ref = _oracle_rollout(sol, (1.0, -0.5),
                                   [fixed] * (cfg.N - 1))
    np.testing.assert_allclose(np.asarray(U), U_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(X), X_ref, rtol=1e-4, atol=1e-4)


def _chip_smoke():
    """chip_smoke.py's float64 Kirk helpers (the card's Kirk reference)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("impl", ["gather", "stencil", "basegather"])
def test_float64_oracle_matches_the_float32_solves(impl):
    cs = _chip_smoke()
    cfg = kirk.KirkConfig(N=7, dx=20, du=41)
    V64, A64 = cs.kirk_oracle64(cfg, cfg.N - 1)
    assert V64.dtype == np.float64 and A64.shape == (cfg.N - 1, 20, 20)
    res = kirk.solve(cfg, impl=impl).result
    err, agree = cs.reading(impl, res.values, res.argmin, V64, A64[-1])
    assert err < cs.RTOL and agree >= cs.MIN_AGREE, (err, agree)


def test_golden_flight_matches_float64_flight():
    cs = _chip_smoke()
    cfg = kirk.KirkConfig.golden()
    X64, U64 = cs.kirk_flight64(cfg, cs.kirk_oracle64(cfg, cfg.N - 1)[1],
                                (2.0, 1.0))
    X, U = kirk.optimal_path(kirk.solve(cfg), (2.0, 1.0))
    assert X64.shape == (cfg.N, 2) and U64.shape == (cfg.N - 1,)
    np.testing.assert_allclose(np.asarray(X), X64, atol=cs.GOLDEN_ATOL)
    np.testing.assert_allclose(np.asarray(U), U64, atol=cs.GOLDEN_ATOL)
    np.testing.assert_allclose(U64[:3], [-7.3, -4.0, -2.4], atol=0.15)
