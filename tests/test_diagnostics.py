"""Diagnostics: compare_solutions, stage probes, viz smoke tests."""

import numpy as np

from ocdp_tpu import value_iteration_finite
from ocdp_tpu.diagnostics import compare_solutions, compare_stage_probes
from ocdp_tpu.models import kirk


def test_compare_solutions_and_probes():
    cfg = kirk.KirkConfig(N=8, dx=12, du=9)
    p = kirk.build(cfg)
    win = ((4, 3), (5, 3))
    a = value_iteration_finite(p.plan, p.stage_cost, 7, probe_window=win)
    b = value_iteration_finite(p.plan, p.stage_cost, 7, probe_window=win)
    rep = compare_solutions(a, b)
    assert rep and rep.max_value_diff == 0.0 and rep.policy_mismatch_frac == 0.0
    assert a.probes.shape == (7, 3, 3)
    assert compare_stage_probes(a.probes, b.probes)
    # perturbed run must NOT compare equal
    c = value_iteration_finite(p.plan, p.stage_cost + np.float32(1e-3), 7,
                               probe_window=win)
    assert not compare_solutions(a, c)
    assert not compare_stage_probes(a.probes, c.probes)
    # probe window equals the same slice of the final table at the last sweep
    np.testing.assert_array_equal(np.asarray(a.probes[-1]),
                                  np.asarray(a.values[4:7, 5:8]))


def test_viz_smoke(tmp_path):
    from ocdp_tpu import viz

    cfg = kirk.KirkConfig(N=6, dx=10, du=7)
    sol = kirk.solve(cfg)
    X, U = kirk.optimal_path(sol, (1.0, 0.5))
    u_star = np.asarray(sol.u_star)
    axes = sol.problem.grid.axes
    f1 = viz.plot_policy_surface(u_star[0], axes, stage=0,
                                 path=str(tmp_path / "surf.png"))
    f2 = viz.plot_policy_stages(u_star, axes, path=str(tmp_path / "stages.png"))
    f3 = viz.plot_rollout(np.arange(len(X)) * 1.0, X, U,
                          path=str(tmp_path / "roll.png"))
    T = np.arange(9)
    f4 = viz.plot_thruster_dashboard(T, np.zeros((8, 12)),
                                     path=str(tmp_path / "thr.png"))
    f5 = viz.plot_forces_moments(T, np.zeros((8, 6)),
                                 path=str(tmp_path / "fm.png"))
    for name in ("surf", "stages", "roll", "thr", "fm"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0
    import matplotlib.pyplot as plt

    plt.close("all")


def test_cli_solve_and_rollout_smoke(capsys):
    import json

    from ocdp_tpu.__main__ import main

    main(["rollout", "kirk", "--impl", "gather"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["problem"] == "kirk"
    assert abs(out["x_final"][0]) < 0.1 and abs(out["x_final"][1]) < 0.1


def test_sweep_timer_counters():
    """profiling.SweepTimer integrates with the segmented + converged
    engines (the reference's per-stage toc prints, Dynamic_Solver.m:87)."""
    from ocdp_tpu import value_iteration_converged, value_iteration_segmented
    from ocdp_tpu.models import kirk
    from ocdp_tpu.profiling import SweepTimer

    p = kirk.build(kirk.KirkConfig(N=8, dx=12, du=10))
    t = SweepTimer()
    value_iteration_segmented(p.plan, p.stage_cost, 6, segment_size=2,
                              on_segment=t.on_segment)
    assert t.total_sweeps == 6
    assert t.sweeps_per_s > 0

    t2 = SweepTimer()
    import jax

    value_iteration_converged(p.plan, p.stage_cost, 6, check_every=2,
                              tol=0.0, on_check=t2.on_check)
    jax.effects_barrier()


def test_pos_att_high_res_config_builds():
    """BASELINE.json config #5: the high-res coupled grid is a first-class
    named config; building its channel problem must work (solving it is
    chip_smoke.py's job on the GPU, not CI's)."""
    from ocdp_tpu.models import pos_att

    cfg = pos_att.PosAttConfig.high_res()
    problem = pos_att.build_channel(cfg, "x")
    assert problem.plan.query_shape == (60, 60, 40, 30, 9)


def test_animate_policy_surface_writes_gif(tmp_path):
    from ocdp_tpu.models import kirk
    from ocdp_tpu.viz import animate_policy_surface

    sol = kirk.solve(kirk.KirkConfig(N=5, dx=9, du=7))
    path = str(tmp_path / "u_star.gif")
    animate_policy_surface(np.asarray(sol.u_star), sol.problem.grid.axes,
                           path, stages=[0, 1, 2])
    import os

    assert os.path.getsize(path) > 1000


def test_compare_solutions_verbose_prints_verdict(capsys):
    """The reference's console verdict (test/Dynamic_Solver.m:273-277)."""
    import numpy as np

    from ocdp_tpu.diagnostics import compare_solutions

    class R:
        values = np.zeros((3, 3), np.float32)
        argmin = np.zeros((3, 3), np.int32)

    class R2:
        values = np.ones((3, 3), np.float32)
        argmin = np.zeros((3, 3), np.int32)

    compare_solutions(R, R, verbose=True)
    assert "Data is equal" in capsys.readouterr().out
    compare_solutions(R, R2, verbose=True)
    assert "NOT equal" in capsys.readouterr().out


def test_cli_flag_matrix_smoke(capsys, monkeypatch, tmp_path):
    """Every advertised CLI flag does something on every problem
    (VERDICT r4 item 8): --sweeps/--impl/--tol-mode reach the solvers
    (captured via wrappers), --quiet suppresses the default reference-
    parity per-stage prints, and the full solve matrix runs on small
    monkeypatched configs."""
    import json

    from ocdp_tpu.__main__ import main
    from ocdp_tpu.models import attitude, kirk, pos_att, position

    def factory(cls, **defaults):
        def make(**kw):
            return cls(**{**defaults, **kw})

        for attr in ("golden", "high_res"):
            if hasattr(cls, attr):
                setattr(make, attr, getattr(cls, attr))
        return make

    monkeypatch.setattr(kirk, "KirkConfig",
                        factory(kirk.KirkConfig, N=5, dx=9, du=7))
    monkeypatch.setattr(position, "PositionConfig",
                        factory(position.PositionConfig, n_mesh_x=10,
                                n_mesh_v=10))
    monkeypatch.setattr(attitude, "AttitudeConfig",
                        factory(attitude.AttitudeConfig, n_mesh_w=7,
                                n_mesh_t=9, n_mesh_q=4))
    monkeypatch.setattr(pos_att, "PosAttConfig",
                        factory(pos_att.PosAttConfig, n_mesh_x=6,
                                n_mesh_v=6, n_mesh_t=5, n_mesh_w=4))

    # --sweeps / --tol-mode / --impl reach pos_att.solve
    seen = {}
    real_solve = pos_att.solve

    def wrap_solve(*a, **kw):
        seen.update(kw)
        return real_solve(*a, **kw)

    monkeypatch.setattr(pos_att, "solve", wrap_solve)
    main(["solve", "pos-att", "--sweeps", "3", "--tol-mode", "rel",
          "--impl", "stencil", "--quiet", "--out", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["problem"] == "pos-att"
    assert seen["max_sweeps"] == 3 and seen["tol_mode"] == "rel"
    assert seen["impl"] == "stencil" and seen["verbose"] is False
    assert (tmp_path / "channel_x_controller_1.npz").exists()

    # --impl reaches rollout position (round-3 bug class, fixed for all)
    seen.clear()
    real_psolve = position.solve

    def wrap_psolve(*a, **kw):
        seen.update(kw)
        return real_psolve(*a, **kw)

    monkeypatch.setattr(position, "solve", wrap_psolve)
    main(["rollout", "position", "--impl", "gather", "--sweeps", "3",
          "--quiet"])
    capsys.readouterr()
    assert seen["impl"] == "gather" and seen["num_sweeps"] == 3

    # remaining solve matrix runs; default (no --quiet) prints the
    # reference's per-stage 'step %d - %f seconds' lines
    main(["solve", "kirk", "--sweeps", "3", "--impl", "stencil"])
    text = capsys.readouterr().out
    assert "step 1 - " in text and "step 3 - " in text
    for argv in (
        ["solve", "position", "--sweeps", "3", "--quiet"],
        ["solve", "attitude", "--sweeps", "3", "--impl", "stencil",
         "--quiet"],
        ["solve", "attitude-full", "--sweeps", "2", "--n-mesh-w", "5",
         "--n-mesh-q", "4", "--quiet"],
    ):
        main(argv)
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["problem"] == argv[1]


def test_cli_attitude_full_checkpoint_flags(capsys, monkeypatch, tmp_path):
    """solve attitude-full --segment-size/--checkpoint/--resume/--tol run
    the segmented envelope form; other problems reject the flags loudly."""
    import json

    import pytest as _pytest

    from ocdp_tpu.__main__ import main

    ck = str(tmp_path / "att.npz")
    main(["solve", "attitude-full", "--n-mesh-w", "5", "--n-mesh-q", "4",
          "--sweeps", "6", "--segment-size", "3", "--checkpoint", ck,
          "--quiet"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sweeps"] == 6
    from ocdp_tpu.io import load_values

    _, sweep, _ = load_values(ck)
    assert sweep == 6
    main(["solve", "attitude-full", "--n-mesh-w", "5", "--n-mesh-q", "4",
          "--sweeps", "9", "--segment-size", "3", "--checkpoint", ck,
          "--resume", "--quiet"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sweeps"] == 3        # 9 total, 6 resumed
    with _pytest.raises(SystemExit, match="attitude-full"):
        main(["solve", "kirk", "--checkpoint", ck])
