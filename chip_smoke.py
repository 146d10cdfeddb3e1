"""Smoke test of ocdp_tpu's main path on one NVIDIA GPU (H100).

Runs, in this one process, every problem family through its public entry
point with ``impl='auto'`` at the reference's own problem sizes, compares
each with the repo's plain reference on the card, flies the rollouts, and
times the row/lane Triton kernel against the XLA stencil:

  (a) device     the backend must be a GPU, else exit non-zero;
  (b) families   Kirk (full + golden), position, attitude simplified and
                 full 6-D (11^3 x 10^3, 5999 sweeps checked every 50),
                 pos-att (4 channels, one program) — Kirk checked against
                 a float64 solve and flight, the others against the
                 gather oracle (pos-att: the stencil solve);
  (c) rollouts   single flights on the card and on the host, and a
                 256-flight fleet on the card;
  (d) timing     kernel vs plain XLA, compile time as set-up, memory;
  (f) gpu tests  the test suite's ``gpu``-marked cases.

Usage::

    python chip_smoke.py            # one card: phases (a)-(d), (f)
    python chip_smoke.py --four     # four cards: (e), the multi-card paths
                                    # and the one-card solves they match

Tolerances. After ORACLE_SWEEPS sweeps: values to rtol 1e-5 of the
table's scale (FMA contraction and summation order differ between the two
programs) and argmin agreement >= 0.999 (flips only at float near-ties).
Kirk is held to a float64 solve instead, at KIRK_SWEEPS: every float32
path, the gather oracle included, drifts from it (up to ~2e-4 of scale
near sweep 10, ~1e-5 at 199) because linear extrapolation at the grid
edge weights rounding errors by up to ~37 per sweep, and its 1000 finely
spaced controls leave ~1% of argmins on near-ties. So the auto path may be
at most KIRK_VS_F32 times as far from float64 as the gather oracle is
(or within 1e-5), with at most KIRK_AGREE_SLACK less argmin agreement.
The golden flight follows the float64 flight to GOLDEN_ATOL (float32
rounding over 129 steps is ~3e-6; one flipped policy cell moves it by a
control step, ~0.5). A single flight on the card follows the host's to
1e-4 until the first step where the discontinuous policy lookup picks
another action. Any failure exits non-zero; the last line of standard
output is one JSON object, printed only on success.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

RTOL = 1e-5
MIN_AGREE = 0.999
ORACLE_SWEEPS = 20
# Kirk against its float64 solve: the drift peak of the extrapolating
# edge cells, the horizon that failed a flat 1e-5, and the full horizon
KIRK_SWEEPS = (10, 20, 199)
KIRK_VS_F32 = 2.0
KIRK_AGREE_SLACK = 0.005
GOLDEN_ATOL = 1e-4
FLIGHT_ATOL = 1e-4


def card_line() -> str:
    """The card's name and power limit, read by a child process before
    JAX starts (nvidia-smi stays off the card's memory)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or out.stderr.strip()


def log(*parts):
    print(*parts, flush=True)


def timed(fn, *args, **kw):
    """(result, seconds) with the result computed on the device."""
    import jax

    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def reading(name, got_v, got_a, ref_v, ref_a):
    """(max |dV| over the reference table's scale, argmin agreement)."""
    import numpy as np

    got_v, ref_v = np.asarray(got_v), np.asarray(ref_v)
    if got_v.shape != ref_v.shape or not np.all(np.isfinite(got_v)):
        raise AssertionError(f"{name}: shape {got_v.shape} vs "
                             f"{ref_v.shape} or non-finite values")
    scale = max(1.0, float(np.abs(ref_v).max()))
    err = float(np.abs(got_v - ref_v).max()) / scale
    return err, float((np.asarray(got_a) == np.asarray(ref_a)).mean())


def compare(name, got_v, got_a, ref_v, ref_a):
    """Values to RTOL of the table's scale, argmin agreement >= MIN_AGREE."""
    err, agree = reading(name, got_v, got_a, ref_v, ref_a)
    log(f"  {name}: max |dV|/scale {err:.3g} (limit {RTOL}), "
        f"argmin agreement {agree:.6f} (limit {MIN_AGREE})")
    if err > RTOL or agree < MIN_AGREE:
        raise AssertionError(f"{name} disagrees with its reference")


def memory_line(dev):
    stats = dev.memory_stats() or {}
    return f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}"


def kirk_oracle64(cfg, n):
    """Kirk's value table after ``n`` sweeps and every sweep's argmin
    (``(n, dx, dx)``, sweep order), solved in float64
    on the card and written here apart from the package: bilinear
    interpolation with the reference's linear extrapolation past the grid
    edge (test/Dynamic_Solver.m:207), first minimum over the controls."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ocdp_tpu.grids import linspace_axis

    with jax.enable_x64(True):
        s = jnp.asarray(linspace_axis(cfg.x_min, cfg.x_max, cfg.dx),
                        jnp.float64)
        u = jnp.asarray(linspace_axis(cfg.u_min, cfg.u_max, cfg.du),
                        jnp.float64)
        x1, x2, uu = s[:, None, None], s[None, :, None], u[None, None, :]
        (a11, a12), (a21, a22) = cfg.A

        def locate(q):
            lo = jnp.clip(jnp.searchsorted(s, q, side="right") - 1,
                          0, cfg.dx - 2)
            return lo, (q - s[lo]) / (s[lo + 1] - s[lo])

        l1, f1 = locate(a11 * x1 + a12 * x2 + cfg.B[0] * uu)
        l2, f2 = locate(a21 * x1 + a22 * x2 + cfg.B[1] * uu)
        cost = cfg.Q[0] * x1**2 + cfg.Q[1] * x2**2 + cfg.R * uu**2

        @jax.jit     # the query tables ride as arguments, not constants
        def sweeps(V, l1, f1, l2, f2, cost):
            def sweep(V, _):
                tot = (cost + (1 - f1) * (1 - f2) * V[l1, l2]
                       + (1 - f1) * f2 * V[l1, l2 + 1]
                       + f1 * (1 - f2) * V[l1 + 1, l2]
                       + f1 * f2 * V[l1 + 1, l2 + 1])
                return tot.min(-1), tot.argmin(-1)
            return jax.lax.scan(sweep, V, None, length=n)

        V, A = sweeps(jnp.zeros((cfg.dx, cfg.dx), jnp.float64),
                      l1, f1, l2, f2, cost)
        return np.asarray(V), np.asarray(A)


# ---------------------------------------------------------------- phases

def kirk_flight64(cfg, argmins, x0):
    """The golden flight in float64 on the host: per stage, the stage's
    policy table (controls at the oracle's argmins, forward order) read
    bilinearly with extrapolation, then ``x' = A x + B u``."""
    import numpy as np

    from ocdp_tpu.grids import linspace_axis

    s = linspace_axis(cfg.x_min, cfg.x_max, cfg.dx).astype(np.float64)
    u = linspace_axis(cfg.u_min, cfg.u_max, cfg.du).astype(np.float64)

    def locate(q):
        lo = int(np.clip(np.searchsorted(s, q, side="right") - 1,
                         0, cfg.dx - 2))
        return lo, (q - s[lo]) / (s[lo + 1] - s[lo])

    A, B = np.asarray(cfg.A), np.asarray(cfg.B)
    x, X, U = np.asarray(x0, np.float64), [], []
    for table in u[np.asarray(argmins)][::-1]:
        (i, f), (j, g) = locate(x[0]), locate(x[1])
        uk = ((1 - f) * (1 - g) * table[i, j] + (1 - f) * g * table[i, j + 1]
              + f * (1 - g) * table[i + 1, j] + f * g * table[i + 1, j + 1])
        X.append(x)
        U.append(uk)
        x = A @ x + B * uk
    return np.array(X + [x]), np.array(U)


def phase_kirk():
    import numpy as np

    from ocdp_tpu.models import kirk

    log("(b) kirk")
    for n in KIRK_SWEEPS:
        c = kirk.KirkConfig(N=n + 1)
        o_v, o_a = kirk_oracle64(c, n)
        got = kirk.solve(c, store_policies=False).result
        ref = kirk.solve(c, impl="gather", store_policies=False).result
        e_got, a_got = reading("kirk auto", got.values, got.argmin, o_v, o_a[-1])
        e_ref, a_ref = reading("kirk gather", ref.values, ref.argmin, o_v,
                               o_a[-1])
        e_max = max(RTOL, KIRK_VS_F32 * e_ref)
        log(f"  kirk {n} sweeps vs float64: auto max |dV|/scale {e_got:.3g} "
            f"(limit {e_max:.3g}), argmin agreement {a_got:.6f} (limit "
            f"{a_ref - KIRK_AGREE_SLACK:.6f}); gather oracle {e_ref:.3g}, "
            f"{a_ref:.6f}")
        if e_got > e_max or a_got < a_ref - KIRK_AGREE_SLACK:
            raise AssertionError(f"kirk {n} sweeps: auto is less accurate "
                                 "than the float32 gather oracle")
    cfg = kirk.KirkConfig()
    sol, dt = timed(lambda: kirk.solve(cfg))
    v = np.asarray(sol.result.values)
    assert v.shape == (cfg.dx, cfg.dx) and np.all(np.isfinite(v))
    log(f"  kirk full 100x100x1000 x 199 sweeps: {dt:.3f} s "
        "(first call, compile included)")

    gcfg, x0 = kirk.KirkConfig.golden(), (2.0, 1.0)
    X64, U64 = kirk_flight64(gcfg, kirk_oracle64(gcfg, gcfg.N - 1)[1], x0)
    log(f"  golden float64 flight: U[:3] {U64[:3].round(3).tolist()}, "
        f"X[-1] {X64[-1].round(4).tolist()}")
    if not np.allclose(U64[:3], [-7.3, -4.0, -2.4], atol=0.15):
        raise AssertionError("kirk golden float64 flight off its reference")
    for impl in ("auto", "gather"):
        X, U = kirk.optimal_path(kirk.solve(gcfg, impl=impl), x0)
        dx = float(np.abs(np.asarray(X) - X64).max())
        du = float(np.abs(np.asarray(U) - U64).max())
        log(f"  golden {impl} vs float64 flight: max |dX| {dx:.3g}, max "
            f"|dU| {du:.3g} (limit {GOLDEN_ATOL} each)")
        if dx > GOLDEN_ATOL or du > GOLDEN_ATOL:
            raise AssertionError(f"kirk golden {impl} flight off float64")


def phase_position():
    import numpy as np

    from ocdp_tpu.models import position

    log("(b) position")
    cfg = position.PositionConfig()
    got = position.solve(cfg, num_sweeps=ORACLE_SWEEPS).result
    ref = position.solve(cfg, num_sweeps=ORACLE_SWEEPS, impl="gather").result
    compare(f"position {ORACLE_SWEEPS} sweeps vs gather", got.values,
            got.argmin, ref.values, ref.argmin)
    sol, dt = timed(lambda: position.solve(cfg))
    assert np.all(np.isfinite(np.asarray(sol.result.values)))
    log(f"  position 3x201x201x3 x {cfg.n_stage - 1} sweeps: {dt:.3f} s "
        "(first call)")
    return sol


def phase_attitude_simplified():
    import numpy as np

    from ocdp_tpu.models import attitude

    log("(b) attitude simplified")
    cfg = attitude.AttitudeConfig()
    got = attitude.solve_simplified(cfg, num_sweeps=ORACLE_SWEEPS)
    ref = attitude.solve_simplified(cfg, num_sweeps=ORACLE_SWEEPS,
                                    impl="gather")
    for i in range(3):
        compare(f"attitude axis {i} {ORACLE_SWEEPS} sweeps vs gather",
                got.values[i], got.u_tables[i], ref.values[i],
                ref.u_tables[i])
    sol, dt = timed(lambda: attitude.solve_simplified(cfg))
    assert all(np.all(np.isfinite(np.asarray(v))) for v in sol.values)
    log(f"  attitude simplified 3x1000x300x3 x {cfg.n_stage - 1} sweeps: "
        f"{dt:.3f} s (first call)")
    return sol


def phase_attitude_full():
    import numpy as np

    from ocdp_tpu.models import attitude

    log("(b) attitude full 6-D")
    cfg = attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10)
    got = attitude.solve_full(cfg, num_sweeps=ORACLE_SWEEPS)
    ref = attitude.solve_full(cfg, num_sweeps=ORACLE_SWEEPS, impl="gather")
    compare(f"attitude 6-D {ORACLE_SWEEPS} sweeps vs gather",
            got.result.values, got.result.argmin, ref.result.values,
            ref.result.argmin)
    sol, dt = timed(lambda: attitude.solve_full(
        cfg, segment_size=50, tol=1e-2))
    res = sol.result
    assert np.all(np.isfinite(np.asarray(res.values)))
    log(f"  attitude 6-D 1.33M cells x 27: {int(res.num_sweeps)} sweeps "
        f"checked every 50 (converged={bool(res.converged)}): {dt:.3f} s "
        "(first call)")
    return sol


def phase_pos_att():
    import numpy as np

    from ocdp_tpu.models import pos_att

    log("(b) pos-att")
    cfg = pos_att.PosAttConfig()
    for ch in pos_att.CHANNELS:
        got_c, _ = pos_att.solve_channel(cfg, ch, max_sweeps=ORACLE_SWEEPS)
        ref_c, _ = pos_att.solve_channel(cfg, ch, impl="stencil",
                                         max_sweeps=ORACLE_SWEEPS)
        compare(f"pos-att {ch} {ORACLE_SWEEPS} sweeps vs stencil",
                got_c.values, got_c.argmin, ref_c.values, ref_c.argmin)
    sol, dt = timed(lambda: pos_att.solve(cfg))
    for name, c in sol.controllers.items():
        assert np.all(np.isfinite(c.values)), name
    log(f"  pos-att 4 channels, one program, cap {cfg.n_stage - 1} "
        f"sweeps: {dt:.3f} s (first call)")
    return sol


def same_flight(name, X_card, X_host, A_card, A_host):
    """A flight on the card follows the host's to FLIGHT_ATOL up to the
    first step whose (discontinuous) policy lookup picks another action;
    both must stay finite."""
    import numpy as np

    X_card, X_host = np.asarray(X_card), np.asarray(X_host)
    A_card = np.asarray(A_card).reshape(len(A_card), -1)
    A_host = np.asarray(A_host).reshape(len(A_host), -1)
    differs = np.flatnonzero(np.any(A_card != A_host, axis=1))
    k = int(differs[0]) if differs.size else len(A_card)
    d = float(np.abs(X_card[:k + 1] - X_host[:k + 1]).max())
    log(f"  {name}: card vs host max |dX| {d:.3g} (limit {FLIGHT_ATOL}) "
        f"over the {k} steps before the actions first differ "
        f"(of {len(A_card)})")
    if not (np.all(np.isfinite(X_card)) and d <= FLIGHT_ATOL):
        raise AssertionError(f"{name} differs card vs host")


def phase_rollouts(pos_sol, att_full):
    import numpy as np

    from ocdp_tpu.models import attitude, pos_att

    log("(c) rollouts")
    # the full 10 s flight in the 'rk4' serving mode; ode45 parity mode
    # over its first second (its adaptive loops are ~100x slower on the
    # card than on the host)
    for integ, t_final in (("rk4", None), ("ode45", 1.0)):
        outs = {}
        for dev in ("default", "cpu"):
            kw = dict(integrator=integ, device=dev, t_final=t_final)
            pos_att.get_optimal_path(pos_sol, **kw)
            outs[dev], dt = timed(pos_att.get_optimal_path, pos_sol, **kw)
            log(f"  pos-att single flight {integ} "
                f"({len(outs[dev][0]) - 1} steps) on "
                f"{'card' if dev == 'default' else 'host'}: {dt:.4f} s warm")
        same_flight(f"pos-att flight {integ}", outs["default"][1],
                    outs["cpu"][1], outs["default"][2], outs["cpu"][2])
    x0s = np.tile(np.asarray(pos_att.default_x0()), (256, 1))
    x0s += np.random.default_rng(0).normal(0, 0.01, x0s.shape).astype(
        np.float32)
    pos_att.rollout_batch(pos_sol, x0s)
    (T, X, _, _), dt = timed(pos_att.rollout_batch, pos_sol, x0s)
    assert X.shape == (256, len(T), 13) and np.all(np.isfinite(X))
    log(f"  pos-att fleet of 256 flights on card: {dt:.4f} s warm")
    X_d, U_d, _ = attitude.rollout_full(att_full, device="default")
    X_h, U_h, _ = attitude.rollout_full(att_full, device="cpu")
    same_flight("attitude 6-D flight", X_d, X_h, U_d, U_h)


def phase_timing(dev):
    import jax

    from ocdp_tpu.engine import value_iteration_finite
    from ocdp_tpu.models import attitude, kirk, pos_att
    from ocdp_tpu.ops.basegather import build_basegather_backup
    from ocdp_tpu.ops.interp import PlanShape
    from ocdp_tpu.ops.pallas_backup6 import build_pallas_backup_6d
    from ocdp_tpu.ops.sheargather import build_sheargather_backup
    from ocdp_tpu.ops.stencil import build_stencil_backup

    log("(d) kernel vs plain XLA (block_until_ready; warm minimum of 3)")

    def bench(name, fn, *args, sweeps):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        setup = time.perf_counter() - t0
        jax.block_until_ready(compiled(*args))
        best = min(timed(compiled, *args)[1] for _ in range(3))
        mem = compiled.memory_analysis()
        log(f"  {name}: {1e3 * best / sweeps:.4f} ms/sweep over {sweeps} "
            f"sweeps, compile {setup:.1f} s, temp "
            f"{getattr(mem, 'temp_size_in_bytes', None)} B")
        return best / sweeps

    def finite(n, backup, closed):
        if closed:
            return lambda plan, cost: value_iteration_finite(
                plan, cost, n, backup=backup)
        return lambda plan, cost, b: value_iteration_finite(
            plan, cost, n, backup=b)

    n = 20
    cfg = attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10)
    grid, plan, cost = attitude.build_full(cfg)
    bk = build_pallas_backup_6d(plan, cost)
    bench("attitude 6-D rowlane", finite(n, None, False),
          PlanShape.of(plan), None, bk, sweeps=n)
    st = build_stencil_backup(plan, cost, action_chunk=9, state_blocks=1,
                              weight_mode="precomputed")
    bench("attitude 6-D stencil", finite(n, None, False),
          plan, cost, st, sweeps=n)

    for label, pcfg in (("pos-att reference", pos_att.PosAttConfig()),
                        ("pos-att high-res", pos_att.PosAttConfig.high_res())):
        p = pos_att.build_channel(pcfg, "x")
        n = 200
        rl = pos_att.build_channel_rowlane_backup(pcfg, p)
        bench(f"{label} x channel rowlane", finite(n, None, False),
              PlanShape.of(p.plan), None, rl, sweeps=n)
        st = build_stencil_backup(p.plan, p.stage_cost)
        bench(f"{label} x channel stencil", finite(n, st, True),
              p.plan, p.stage_cost, sweeps=n)

    kcfg = kirk.KirkConfig()
    kp = kirk.build(kcfg)
    n = kcfg.N - 1
    sg = build_sheargather_backup(kp.plan, kp.stage_cost, action_chunk=20)
    bench("kirk sheargather", finite(n, None, False), kp.plan,
          kp.stage_cost, sg, sweeps=n)
    bg = build_basegather_backup(kp.plan, kp.stage_cost, action_chunk=50)
    bench("kirk basegather", finite(n, None, False), kp.plan,
          kp.stage_cost, bg, sweeps=n)
    st = build_stencil_backup(kp.plan, kp.stage_cost, action_chunk=50)
    bench("kirk stencil", finite(n, st, True), kp.plan, kp.stage_cost,
          sweeps=n)
    log(f"  {memory_line(dev)}")


def phase_gpu_tests():
    import os

    import pytest

    log("(f) gpu-marked tests")
    os.environ["OCDP_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/test_rowlane_kernel.py"])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest rc {rc})")


def phase_four():
    """Multi-card paths vs their one-card solves (--four)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from ocdp_tpu.engine import (value_iteration_converged,
                                 value_iteration_finite)
    from ocdp_tpu.models import attitude, kirk, pos_att
    from ocdp_tpu.ops.pallas_backup6 import build_pallas_backup_6d
    from ocdp_tpu.ops.stencil import build_stencil_backup
    from ocdp_tpu.parallel import (value_iteration_converged_sharded,
                                   value_iteration_finite_halo,
                                   value_iteration_finite_halo6,
                                   value_iteration_finite_sharded)
    from ocdp_tpu.parallel.comms import measure_halo6_comms

    devs = np.array(jax.devices()[:4])
    if len(devs) != 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    log("(e) four cards")
    mesh22 = Mesh(devs.reshape(2, 2), ("s", "a"))
    mesh4 = Mesh(devs, ("s",))

    n = ORACLE_SWEEPS
    p = kirk.build(kirk.KirkConfig())
    ref = value_iteration_finite(p.plan, p.stage_cost, n)
    got, dt = timed(value_iteration_finite_sharded, p.plan, p.stage_cost,
                    n, mesh22, action_axis_name="a")
    compare(f"kirk finite sharded (2,2) ({dt:.2f} s)", got.values,
            got.argmin, ref.values, ref.argmin)
    ref = value_iteration_converged(p.plan, p.stage_cost, n, check_every=1,
                                    tol=0.0)
    got, dt = timed(value_iteration_converged_sharded, p.plan, p.stage_cost,
                    n, mesh22, check_every=1, tol=0.0,
                    action_axis_name="a")
    compare(f"kirk converged sharded (2,2) ({dt:.2f} s)", got.values,
            got.argmin, ref.values, ref.argmin)

    ref = value_iteration_finite(
        p.plan, p.stage_cost, n,
        backup=build_stencil_backup(p.plan, p.stage_cost, action_chunk=50))
    got, dt = timed(value_iteration_finite_halo, p.plan, p.stage_cost, n,
                    mesh4, action_chunk=50)
    compare(f"kirk finite halo x4 ({dt:.2f} s)", got.values, got.argmin,
            ref.values, ref.argmin)

    cfg = attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10)
    _, aplan, acost = attitude.build_full(cfg)
    abk = build_pallas_backup_6d(aplan, acost)
    ref = value_iteration_finite(aplan, acost, n, backup=abk)
    got, dt = timed(value_iteration_finite_halo6, aplan, acost, n, mesh4)
    compare(f"attitude 6-D halo6 rows x4 ({dt:.2f} s)", got.values,
            got.argmin, ref.values, ref.argmin)

    pcfg = pos_att.PosAttConfig()
    sol, dt = timed(lambda: pos_att.solve_ep(pcfg, mesh=Mesh(devs, ("c",)),
                                             max_sweeps=n))
    log(f"  pos-att solve_ep, one channel per card: {dt:.2f} s")
    for name, ctrl in sol.controllers.items():
        ref_c, _ = pos_att.solve_channel(
            pcfg, name.replace("_failure", ""), failure="failure" in name,
            max_sweeps=n)
        compare(f"pos-att EP {name} vs one card", ctrl.values, ctrl.argmin,
                ref_c.values, ref_c.argmin)

    m = measure_halo6_comms(cfg, 4)
    log(f"  halo6 permute bytes per device per sweep: compiled HLO "
        f"{m['permute_bytes_per_dev_sweep_hlo']}, analytic "
        f"{m['permute_bytes_per_dev_sweep_analytic']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    card = card_line()            # before JAX touches the card
    import jax

    log("(a) device")
    if jax.default_backend() != "gpu":
        log(f"  no GPU: JAX backend is {jax.default_backend()!r}")
        return 1
    dev = jax.devices()[0]
    log(f"  jax {jax.__version__}, {dev.device_kind}, "
        f"{len(jax.devices())} device(s)")
    log(f"  card: {card}")

    from ocdp_tpu.profiling import enable_compilation_cache

    log(f"  compile cache: {enable_compilation_cache()}")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_kirk()
        phase_position()
        phase_attitude_simplified()
        att_full = phase_attitude_full()
        pos_sol = phase_pos_att()
        phase_rollouts(pos_sol, att_full)
        phase_timing(dev)
        phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"{memory_line(dev)}")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
