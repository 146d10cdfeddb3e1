"""Coupled position+attitude control per body axis (the flagship problem).

JAX re-design of ``pos-att/Solver_pos_att.m``: per channel a 4-D state
(x, v, theta, omega) is driven by 4 on/off thrusters whose pruned
combinations (9 healthy / 6 with a failed thruster) form the action set; the
channel solves run value iteration with the reference's periodic-checksum
early stop, controllers persist to npz, and the closed-loop 13-state
simulation (translation + quaternion attitude + full-inertia Euler
equations) is one on-device scan.

Channel wiring (Solver_pos_att.m:217-240, 404-449): x-translation couples to
pitch about the body y-axis (inertia J2), y to yaw about z (J3), z to roll
about x (J1). A thruster-0 failure variant of the x channel is solved too
(:236-240) — policy families per actuator-failure configuration.

Reference parity:
* ``sym_linspace`` exact-n grids (:906-918), Euler steps (RK4 shells with
  k2..k4 commented out, :330-402), stage cost (:784-802).
* early stop: every 50 sweeps |sum(V) - prev| < 1e-2 (:268-286).
* policy lookup on nearest-neighbor per-thruster force tables (:849-884),
  state transformed RSW->ECI->body with the *initial* target state vector
  (:404-415, a reference quirk: R0,V0 are never advanced for the frame).
* the body-frame accelerations sum(f)/Mass (m/s^2) feed the km-based CW
  equations unscaled (:804-823 + :699-707) — reproduced via
  ``accel_scale=1.0`` default.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..dynamics.orbital import target_orbit_R0V0
from ..dynamics.relmotion import cw_relative_rates
from ..engine import SolveResult, value_iteration_converged
from ..grids import Grid, sym_linspace_exact
from ..io import ChannelController
from ..ops import default_impl
from ..ops.interp import InterpPlan, build_plan
from ..ops.stencil import build_stencil_backup
from ..utils.frames import body_to_rsw, rsw_to_body
from ..utils.quaternions import quat_kinematics, small_angles_from_quat
from .thrusters import (
    SPHERES_MOMENT_ARM,
    SPHERES_THRUSTER_FORCE,
    thruster_combinations,
)

__all__ = [
    "PosAttConfig",
    "CHANNELS",
    "build_channel",
    "build_channel_rowlane_backup",
    "build_ep_rowlane_backups",
    "solve_channel",
    "solve",
    "solve_ep",
    "PosAttSolution",
    "get_optimal_path",
    "rollout_batch",
    "receding_horizon",
]

CHANNELS = ("x", "y", "z")
_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class PosAttConfig:
    # translational grid (Solver_pos_att.m:100-106)
    x_min: float = -0.2
    x_max: float = 0.2
    n_mesh_x: int = 30
    v_min: float = -0.1
    v_max: float = 0.1
    n_mesh_v: int = 30
    # attitude grid (:108-119); per-channel theta ranges in degrees
    w_min_deg: float = -2.0
    w_max_deg: float = 2.0
    n_mesh_w: int = 15
    theta_ranges_deg: tuple = ((-5.0, 5.0), (-6.0, 6.0), (-7.0, 7.0))
    n_mesh_t: int = 20
    # plant (:121-131, :171-192)
    mass: float = 4.16
    inertia_diag: tuple = (0.02836 + 0.00016, 0.026817 + 0.00150, 0.023 + 0.00150)
    inertia_offdiag: tuple = (-0.0000837, 0.000014, -0.00029)  # (Ixy, Ixz, Iyz)
    thruster_force: float = SPHERES_THRUSTER_FORCE
    moment_arm: float = SPHERES_MOMENT_ARM
    # cost (:138-151)
    Qx: float = 6.0
    Qv: float = 6.0
    Qt: float = 0.5
    Qw: float = 0.5
    R: float = 0.1
    # horizon (:155-156)
    T_final: float = 10.0
    h: float = 0.005
    # early stop (:269-284)
    check_every: int = 50
    tol: float = 1e-2
    # rollout parity knob (module docstring)
    accel_scale: float = 1.0

    def __post_init__(self):
        # reference guard rail: warn (and ceil) when T_final/h is not an
        # integer stage count (Solver_pos_att.m:161-165)
        if self.h <= 0:   # degenerate (frozen-dynamics test configs)
            return
        n = self.T_final / self.h
        if abs(n - round(n)) > 1e-9:
            import warnings

            warnings.warn(
                f"T_final/h = {n!r} is not an integer; using "
                f"ceil = {self.n_stage} stages", stacklevel=3)

    @property
    def n_stage(self) -> int:
        return int(np.ceil(self.T_final / self.h))

    @staticmethod
    def high_res() -> "PosAttConfig":
        """BASELINE.json config #5: high-resolution coupled grid.

        60x60x40x30 = 4.32M cells x 9 combos per channel (16x the reference
        parameterization, Solver_pos_att.m:100-119) — the single-chip
        stress point for the coupled family; shard over a mesh
        (parallel/sharded or halo) for multi-chip scaling. Closed-loop
        rollout from arbitrary x0 via :func:`get_optimal_path` is the
        receding-horizon evaluation (the converged infinite-horizon policy
        is queried at every replanning instant, which IS receding-horizon
        control for a stationary problem).
        """
        return PosAttConfig(n_mesh_x=60, n_mesh_v=60, n_mesh_t=40,
                            n_mesh_w=30)

    @property
    def inertia_matrix(self) -> np.ndarray:
        d = self.inertia_diag
        o = self.inertia_offdiag
        return np.array([[d[0], o[0], o[1]],
                         [o[0], d[1], o[2]],
                         [o[1], o[2], d[2]]])

    def channel_inertia(self, channel: str) -> float:
        """x -> J2 (pitch about y), y -> J3, z -> J1 (:217-233)."""
        d = self.inertia_diag
        return {"x": d[1], "y": d[2], "z": d[0]}[channel]

    def thruster_value_sets(self, channel: str, failure: bool = False):
        """Per-thruster admissible force values, (f0, f1, f6, f7) order.

        ``failure=True`` disables the channel's first thruster (:236-240).
        """
        F = self.thruster_force
        pos = np.array([0.0, F])
        neg = np.array([0.0, -F])
        f0 = np.array([0.0]) if failure else pos
        return (f0, pos, neg, neg)


class ChannelProblem(NamedTuple):
    config: PosAttConfig
    channel: str
    failure: bool
    grid: Grid
    forces: np.ndarray     # (n_comb, 4) pruned combinations
    plan: object
    stage_cost: Optional[jax.Array]   # None when built with_cost=False


def _channel_axes(cfg: PosAttConfig, channel: str):
    i = CHANNELS.index(channel)
    t_lo, t_hi = cfg.theta_ranges_deg[i]
    s_x = sym_linspace_exact(cfg.x_min, cfg.x_max, cfg.n_mesh_x)
    s_v = sym_linspace_exact(cfg.v_min, cfg.v_max, cfg.n_mesh_v)
    s_t = sym_linspace_exact(np.deg2rad(t_lo), np.deg2rad(t_hi), cfg.n_mesh_t)
    s_w = sym_linspace_exact(np.deg2rad(cfg.w_min_deg), np.deg2rad(cfg.w_max_deg),
                             cfg.n_mesh_w)
    return s_x, s_v, s_t, s_w


def build_channel(cfg: PosAttConfig, channel: str, *, failure: bool = False,
                  with_cost: bool = True) -> ChannelProblem:
    """Grids, Euler-step next states, stage cost for one channel (:244-265).

    ``with_cost=False`` skips materializing the dense (S, A) stage-cost
    tensor (``stage_cost=None``): the row/lane kernel consumes only the
    FACTORIZED per-axis cost terms, and the dense broadcast sum is several
    full-table temporaries per high-res channel for an array that path
    never reads.

    The whole precompute runs PINNED to the host CPU backend (the
    attitude build_full pattern): the plan arrays are tiny broadcast
    shapes built by dozens of eager ops, each a separate dispatch on an
    accelerator; downstream jits transfer the finished arrays at once, and
    the kernel builders' host-side tap analysis reads them in place.
    """
    s_x, s_v, s_t, s_w = _channel_axes(cfg, channel)
    grid = Grid((s_x, s_v, s_t, s_w))
    forces = thruster_combinations(*cfg.thruster_value_sets(channel, failure))
    J = cfg.channel_inertia(channel)
    h = cfg.h

    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        x = jnp.asarray(s_x)[:, None, None, None, None]
        v = jnp.asarray(s_v)[None, :, None, None, None]
        t = jnp.asarray(s_t)[None, None, :, None, None]
        w = jnp.asarray(s_w)[None, None, None, :, None]
        f = jnp.asarray(forces)  # (nc, 4)
        fsum = (f[:, 0] + f[:, 1] + f[:, 2]
                + f[:, 3])[None, None, None, None, :]
        # moment = (f0 - f1 + f6 - f7) * T_dist (wdynamics, :396-401)
        fmom = (f[:, 0] - f[:, 1] + f[:, 2]
                - f[:, 3])[None, None, None, None, :]

        x_next = x + h * v
        v_next = v + h * fsum / cfg.mass
        t_next = t + h * w
        w_next = w + h * fmom * cfg.moment_arm / J
        plan = build_plan(grid.axes, (x_next, v_next, t_next, w_next))

        cost = None
        if with_cost:
            fsq = (f[:, 0] ** 2 + f[:, 1] ** 2 + f[:, 2] ** 2
                   + f[:, 3] ** 2)
            cost = (cfg.Qx * x**2 + cfg.Qv * v**2 + cfg.Qt * t**2
                    + cfg.Qw * w**2
                    + cfg.R * fsq[None, None, None, None, :])
    return ChannelProblem(cfg, channel, failure, grid, forces, plan, cost)


def _pad_plan_actions(plan: InterpPlan, n_act: int) -> InterpPlan:
    """Edge-repeat a plan's action axis out to ``n_act`` columns.

    Padded actions re-query the last real action's next states (finite
    arithmetic); the caller pairs them with +inf stage cost so the argmin
    can never select them (the reference's short failure-mode action set,
    Solver_pos_att.m:236-240, padded to the full 9-combo width for
    stacked-channel solves)."""
    def pad(a):
        if a.shape[-1] in (1, n_act):
            return a
        reps = jnp.broadcast_to(a[..., -1:],
                                a.shape[:-1] + (n_act - a.shape[-1],))
        return jnp.concatenate([a, reps], axis=-1)

    return InterpPlan(tuple(pad(x) for x in plan.lo),
                      tuple(pad(x) for x in plan.frac), plan.grid_shape)


def build_channel_rowlane_backup(cfg: PosAttConfig, problem: ChannelProblem,
                                 *, n_act: Optional[int] = None,
                                 device="default", **kw):
    """Row/lane kernel under the (v, w, x, t) permutation.

    rows = the action-coupled axes (v' dep (v, u); w' dep (w, u)), lanes =
    the drift axes (x' = x + h v; t' = t + h w) — Solver_pos_att.m:299-328's
    structure is exactly row/lane separable after this permutation. The
    factorized cost terms reproduce ``build_channel``'s stage cost
    (:784-802) term by term.

    ``n_act``: pad the action set out to this width (+inf cost on padded
    combos; see :func:`_pad_plan_actions`). Extra ``**kw`` (``live_sets``,
    ``cost_act_traced``, ``interpret``, ...) pass through to the kernel
    builder.

    The build runs PINNED to the host CPU backend (see
    :func:`build_channel`): the cost-term algebra / plan transposes are
    dozens of tiny eager ops. The finished kernel arrays then move to
    ``device`` (default: the process default device) in ONE batched
    ``device_put`` so solve-time jits read device-resident inputs —
    uncommitted host arrays would be re-transferred on EVERY solve call.
    ``device=None`` skips the commit — required by :func:`solve_ep`, whose
    shard_map distributes the stacked backups over a multi-device mesh
    (arrays committed to device 0 make that jit reject the arguments).
    """
    from ..ops.pallas_backup6 import PermutedRowLaneBackup

    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ax = [jnp.asarray(a, jnp.float32) for a in problem.grid.axes]
        plan = problem.plan
        fsq = (problem.forces ** 2).sum(axis=1).astype(np.float32)
        if n_act is not None and n_act > fsq.shape[0]:
            plan = _pad_plan_actions(plan, n_act)
            fsq = np.concatenate(
                [fsq, np.full(n_act - fsq.shape[0], np.inf, np.float32)])
        backup = PermutedRowLaneBackup(
            plan,
            [cfg.Qx * ax[0][:, None, None, None, None] ** 2,
             cfg.Qv * ax[1][None, :, None, None, None] ** 2,
             cfg.Qt * ax[2][None, None, :, None, None] ** 2,
             cfg.Qw * ax[3][None, None, None, :, None] ** 2,
             cfg.R * jnp.asarray(fsq)[None, None, None, None, :]],
            perm=(1, 3, 0, 2), row_axes=2, **kw)
    if kw.get("analyze_only") or device is None:
        return backup      # tap metadata only / uncommitted host arrays
    if device == "default":
        device = jax.devices()[0]
    return jax.device_put(backup, device)   # pytree-level: ONE batched hop


def build_ep_rowlane_backups(cfg: PosAttConfig, problems, device="default",
                             interpret: bool = False):
    """One rowlane backup per channel, all with IDENTICAL treedefs.

    Channels differ in action-set width (failure channel: 6 of 9 combos)
    and tap structure (per-channel inertia changes the ω-step reach —
    e.g. the y channel's row taps span ±2 cells where x/z span ±1), so a
    naive per-channel build yields incompatible pytrees. Short action sets
    are +inf-padded, per-action costs ride the traced row×action bucket,
    and every backup is rebuilt against the UNION tap structure — extra
    taps carry exactly-zero weight, so each backup's output is unchanged
    (tested bitwise vs its own-structure build). The results stack leaf-
    by-leaf for :func:`solve_ep`'s single shard_mapped program.

    The two-pass build (analysis pass, then union rebuild) is deliberate:
    skipping the rebuild for a channel whose own sets already equal the
    union would NOT guarantee a shared treedef, because the kernel's
    digit-contraction decision is taken only when ``live_sets`` is absent
    (pallas_backup6 ``__init__``) — a natural build and a ``live_sets=``
    build with identical taps can still differ structurally. Build cost
    is ~1 s total at channel scale, paid once per :func:`solve_ep`.
    """
    n_act = max(p.plan.query_shape[-1] for p in problems)
    first = [build_channel_rowlane_backup(cfg, p, n_act=n_act,
                                          analyze_only=True)
             for p in problems]
    from ..ops.pallas_backup6 import union_live_sets

    union = union_live_sets([b.bk for b in first])
    return [build_channel_rowlane_backup(cfg, p, n_act=n_act,
                                         cost_act_traced=True,
                                         live_sets=union, device=device,
                                         interpret=interpret)
            for p in problems]


def _channel_problems(cfg: PosAttConfig, include_failure: bool):
    """(names, problems) for the all-channel solvers — x, y, z (+ the
    thruster-0 x-failure variant), cost-free builds (the rowlane paths
    read only the factorized terms)."""
    problems = [build_channel(cfg, ch, with_cost=False) for ch in CHANNELS]
    names = list(CHANNELS)
    if include_failure:
        problems.append(build_channel(cfg, "x", failure=True,
                                      with_cost=False))
        names.append("x_failure")
    return names, problems


def solve_channel(
    cfg: PosAttConfig,
    channel: str,
    *,
    failure: bool = False,
    impl: str = "auto",
    max_sweeps: Optional[int] = None,
    tol_mode: str = "abs",
    verbose: bool = False,
    interpret: bool = False,
) -> tuple[ChannelController, SolveResult]:
    """Early-stopping value iteration for one channel (:268-289).

    ``impl='auto'`` (default) picks the row/lane kernel on a GPU, the XLA
    stencil on the CPU; ``'rowlane'``/``'stencil'``/``'gather'`` force a
    path (``interpret`` runs the kernel in the Pallas interpreter — CPU
    tests).
    ``tol_mode``: 'abs' is the reference stop rule, 'rel' the scale-free
    variant (engine.convergence_stop). ``verbose`` streams the reference's
    per-check 'stage %d ... errorF %f - errorU %f' prints
    (Solver_pos_att.m:272-279) via profiling.SweepTimer.on_check."""
    from ..profiling import sweep_callback

    sweeps = (cfg.n_stage - 1) if max_sweeps is None else max_sweeps
    if impl == "auto":
        impl = default_impl("rowlane")
    # the rowlane path reads only the FACTORIZED cost terms — skip the
    # dense (S, A) stage-cost build (~155 MB/channel at high-res)
    problem = build_channel(cfg, channel, failure=failure,
                            with_cost=impl != "rowlane")
    backup = None
    if impl == "stencil":
        backup = build_stencil_backup(problem.plan, problem.stage_cost)
    elif impl == "rowlane":
        backup = build_channel_rowlane_backup(cfg, problem,
                                              interpret=interpret)
    elif impl != "gather":
        raise ValueError(f"unknown impl {impl!r}")
    # timer created AFTER the builds: the first errorF line must report
    # the solve-side delta, not ~60 s of channel/kernel build
    on_check = sweep_callback(verbose, kind="check")

    if backup is not None and getattr(backup, "traced_argument", False):
        @partial(jax.jit, static_argnames=("n",))
        def _solve_arg(plan, cost, bk, n):
            return value_iteration_converged(
                plan, cost, n, check_every=cfg.check_every, tol=cfg.tol,
                tol_mode=tol_mode, backup=bk, on_check=on_check,
            )

        result = _solve_arg(problem.plan, problem.stage_cost, backup, sweeps)
    else:
        @partial(jax.jit, static_argnames=("n",))
        def _solve(plan, cost, n):
            # backup closed over -> weight stacks become foldable constants
            return value_iteration_converged(
                plan, cost, n, check_every=cfg.check_every, tol=cfg.tol,
                tol_mode=tol_mode, backup=backup, on_check=on_check,
            )

        result = _solve(problem.plan, problem.stage_cost, sweeps)
    ctrl = ChannelController(
        axes=tuple(problem.grid.axes),
        values=np.asarray(result.values),
        argmin=np.asarray(result.argmin),
        forces=problem.forces,
    )
    return ctrl, result


class PosAttSolution(NamedTuple):
    config: PosAttConfig
    controllers: dict  # channel -> ChannelController (+ "x_failure")


def solve(
    cfg: PosAttConfig = PosAttConfig(),
    *,
    include_failure: bool = True,
    impl: str = "auto",
    save_dir: Optional[str] = None,
    max_sweeps: Optional[int] = None,
    tol_mode: str = "abs",
    verbose: bool = False,
    interpret: bool = False,
) -> PosAttSolution:
    """Solve all channels (+ x-failure), the reference's ``simplified_run``.

    The reference loops its channel solves serially, re-entering the same
    MATLAB code path each time (Solver_pos_att.m:217-240). The compiled
    analog of "same code path" is ONE program: on the rowlane path every
    channel backup is rebuilt against the union tap structure / padded
    action width (:func:`build_ep_rowlane_backups` — identical treedef and
    leaf shapes), and passed as a traced argument to a single jitted
    converged engine. x, y, z, and x-failure then share one kernel
    compile; the serial all-channel wall drops from 4x (compile + solve)
    to compile + 4x solve.
    Per-channel results are bitwise those of :func:`solve_channel` on the
    same union backups (tests/test_pos_att_ep.py pins union == natural
    build bitwise).
    """
    from ..io import save_channel_controller

    if impl == "auto":
        impl = default_impl("rowlane")
    from ..profiling import sweep_callback

    on_check = sweep_callback(verbose, kind="check")
    controllers = {}
    if impl == "rowlane":
        from ..ops.interp import PlanShape

        names, problems = _channel_problems(cfg, include_failure)
        backups = build_ep_rowlane_backups(cfg, problems,
                                           interpret=interpret)
        sweeps = (cfg.n_stage - 1) if max_sweeps is None else max_sweeps
        plan_shape = PlanShape.of(problems[0].plan)

        for name, problem, bk in zip(names, problems, backups):
            res = _run_converged_arg(bk, plan_shape, sweeps,
                                     cfg.check_every, cfg.tol, tol_mode,
                                     on_check)
            controllers[name] = ChannelController(
                axes=tuple(problem.grid.axes),
                values=np.asarray(res.values),
                argmin=np.asarray(res.argmin),
                forces=problem.forces,
            )
    else:
        for ch in CHANNELS:
            controllers[ch], _ = solve_channel(cfg, ch, impl=impl,
                                               max_sweeps=max_sweeps,
                                               tol_mode=tol_mode,
                                               verbose=verbose,
                                               interpret=interpret)
        if include_failure:
            controllers["x_failure"], _ = solve_channel(
                cfg, "x", failure=True, impl=impl, max_sweeps=max_sweeps,
                tol_mode=tol_mode, verbose=verbose, interpret=interpret)
    if save_dir is not None:
        import os

        for name, ctrl in controllers.items():
            save_channel_controller(
                os.path.join(save_dir, f"channel_{name}_controller_1.npz"), ctrl)
    return PosAttSolution(cfg, controllers)


@partial(jax.jit, static_argnames=("plan_shape", "n", "check_every", "tol",
                                   "tol_mode", "on_check"))
def _run_converged_arg(bk, plan_shape, n, check_every, tol, tol_mode,
                       on_check):
    """Module-level jit behind the unified :func:`solve`: repeated calls —
    and repeated SOLVES — reuse one traced/compiled program per
    (plan_shape, horizon, stop rule). A nested closure here would re-trace
    every ``solve()`` call (jit caches key on the function object), paying
    the ~1.6 s rebuild the union-treedef design exists to amortize.
    ``on_check`` is static: ``None`` (the library default) caches; a
    fresh verbose callback per call deliberately re-traces (host print
    path serializes the loop anyway)."""
    return value_iteration_converged(
        plan_shape, None, n, check_every=check_every, tol=tol,
        tol_mode=tol_mode, backup=bk, on_check=on_check)


def solve_channel_sharded(
    cfg: PosAttConfig,
    channel: str,
    mesh,
    *,
    failure: bool = False,
    max_sweeps: Optional[int] = None,
    axis_name: str = "s",
    engine: str = "halo",
) -> tuple[ChannelController, SolveResult]:
    """One channel's early-stopping solve SHARDED over a device mesh — the
    scaling path for :meth:`PosAttConfig.high_res` grids (BASELINE.json
    configs #4/#5: the coupled grid "sharded across hosts").

    ``engine='halo'`` keeps the value table sharded on the x axis and
    ppermutes interpolation boundary slabs (the table is the HBM budget at
    high resolution); ``'replicated'`` all_gathers the table each sweep.
    Results equal the single-chip solve (values bitwise for 'replicated';
    halo identical through the stencil backup).
    """
    problem = build_channel(cfg, channel, failure=failure)
    sweeps = (cfg.n_stage - 1) if max_sweeps is None else max_sweeps
    if engine == "halo":
        from ..parallel.halo import value_iteration_converged_halo

        result = value_iteration_converged_halo(
            problem.plan, problem.stage_cost, sweeps, mesh,
            check_every=cfg.check_every, tol=cfg.tol, axis_name=axis_name)
    elif engine == "replicated":
        from ..parallel.sharded import value_iteration_converged_sharded

        result = value_iteration_converged_sharded(
            problem.plan, problem.stage_cost, sweeps, mesh,
            check_every=cfg.check_every, tol=cfg.tol,
            state_axis_name=axis_name)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    ctrl = ChannelController(
        axes=tuple(problem.grid.axes),
        values=np.asarray(result.values),
        argmin=np.asarray(result.argmin),
        forces=problem.forces,
    )
    return ctrl, result


def solve_ep(
    cfg: PosAttConfig = PosAttConfig(),
    mesh=None,
    *,
    include_failure: bool = True,
    axis_name: str = "c",
    max_sweeps: Optional[int] = None,
    tol_mode: str = "abs",
    return_results: bool = False,
    interpret: bool = False,
):
    """All channels solved in ONE mesh dispatch — channel-level expert
    parallelism (SURVEY.md §2.5 EP row).

    The reference runs its four channel solves serially
    (Solver_pos_att.m:217-240); here each mesh device owns one channel.
    :func:`build_ep_rowlane_backups` gives every channel's row/lane
    kernel backup one shared treedef (union tap structure, +inf action
    padding, traced action costs), so their leaves stack into a single
    (C, ...)-leading pytree sharded over the channel mesh axis. The
    shard_mapped program is just :func:`value_iteration_converged` — the
    SAME engine (checksum early stop, check log) the serial solve runs, so
    per-channel stop decisions are identical by construction; each device's
    while_loop simply exits when ITS channel converges (no lockstep, no
    cross-channel collective — an early-stopping channel's device goes
    idle, exactly the serial semantics, concurrently).

    Per-channel values/argmin equal the serial rowlane
    :func:`solve_channel` runs bitwise (tested), and the per-channel
    throughput IS the single-device kernel rate. Returns
    ``PosAttSolution`` (plus a per-channel ``dict`` of result fields —
    ``num_sweeps``/``converged``/``checks`` — when ``return_results``).
    """
    from jax.sharding import Mesh, PartitionSpec as P

    from ..ops.interp import PlanShape

    if mesh is None:
        n_dev = 4 if include_failure else 3
        mesh = Mesh(np.array(jax.devices()[:n_dev]), (axis_name,))
    names, problems = _channel_problems(cfg, include_failure)
    n_ch = len(problems)
    if mesh.shape[axis_name] != n_ch:
        raise ValueError(
            f"mesh axis {axis_name!r} has {mesh.shape[axis_name]} devices "
            f"but {n_ch} channels")
    sweeps = (cfg.n_stage - 1) if max_sweeps is None else max_sweeps

    backups = build_ep_rowlane_backups(cfg, problems, device=None,
                                       interpret=interpret)
    treedefs = {jax.tree_util.tree_structure(b) for b in backups}
    if len(treedefs) != 1:   # union builder guarantees this; fail loudly
        raise AssertionError(
            f"EP backups did not unify to one treedef: {treedefs}")
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *backups)
    plan_shape = PlanShape.of(problems[0].plan)

    def run(stk):
        bk = jax.tree.map(lambda x: x[0], stk)
        res = value_iteration_converged(
            plan_shape, None, sweeps, check_every=cfg.check_every,
            tol=cfg.tol, tol_mode=tol_mode, backup=bk)
        return (res.values[None], res.argmin[None], res.num_sweeps[None],
                res.converged[None], res.checks[None])

    in_specs = (jax.tree.map(
        lambda x: P(*([axis_name] + [None] * (x.ndim - 1))), stacked),)
    out_specs = (P(axis_name),) * 5
    fn = jax.shard_map(run, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    vals, args, n_sweeps, converged, checks = jax.jit(fn)(stacked)

    controllers = {}
    results = {}
    for i, name in enumerate(names):
        controllers[name] = ChannelController(
            axes=tuple(problems[i].grid.axes),
            values=np.asarray(vals[i]),
            argmin=np.asarray(args[i]),
            forces=problems[i].forces,
        )
        results[name] = {
            "num_sweeps": int(n_sweeps[i]),
            "converged": bool(converged[i]),
            "checks": np.asarray(checks[i]),
        }
    sol = PosAttSolution(cfg, controllers)
    return (sol, results) if return_results else sol


def default_x0(pitch_deg: float = 3.0):
    """X0 = [dr; dv; q; w] with dr=[-0.1,0,0] km, 3 deg pitch (:458-466).

    This package's 13-state plant stores the quaternion TRUE scalar-last
    [x y z w] (utils/quaternions.py — its kinematics/DCM are the standard
    scalar-last forms); the reference stores the kirk reversal [z y x w]
    (Solver_pos_att.m:462-463). For the pitch-only default the two orders
    coincide. A general initial attitude must be built with
    ``euler_zyx_to_quat`` (physically-correct scalar-last) — NOT by copying
    reference-ordered components; permute a reference x0's q via
    ``[q3 q2 q1 q4]`` first.
    """
    from ..utils.quaternions import euler_zyx_to_quat

    # host numpy throughout: callers feed this to a jit, which transfers
    # it with the other arguments at once
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        q0 = np.asarray(euler_zyx_to_quat(
            jnp.asarray(0.0), jnp.deg2rad(pitch_deg), jnp.asarray(0.0)))
    return np.concatenate([
        np.array([-0.1, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32),
        q0.astype(np.float32),
        np.zeros(3, np.float32),
    ])


class _PolicyLookup(NamedTuple):
    """Fused nearest-neighbor policy lookup state for the 3 channels.

    ``tables[c]`` holds the per-cell optimal thruster forces of channel
    ``c`` FLAT over cells — (4, n_cells), cells on the minor axis — so
    one affine locate + one column gather per channel replaces the
    reference's 12 'nearest' griddedInterpolant calls per step
    (Solver_pos_att.m:432-447). All
    channels share a grid shape, so their lookups batch into a single
    (3, 4)-shaped locate (ops/interp.nearest_cell_index)."""

    tables: jax.Array   # (3, 4, n_cells) f32
    aff: object         # AffineAxes, leaves with leading channel dim (3, ...)
    strides: jax.Array  # (4,) int32 C-order strides of the state grid


# Device-resident lookups cached per controller set: the high-res force
# table is ~200 MB, and re-uploading it every replanning call would cost
# more than the flight it serves. Strong refs to the controllers keep the
# id() keys valid while cached; FIFO-capped.
_policy_lookup_cache: dict = {}


def _build_policy_lookup(ctrls, device=None) -> _PolicyLookup:
    from ..ops.interp import affine_axes

    if device is None:
        device = jax.devices()[0]
    key = (tuple(id(c) for c in ctrls), device)
    hit = _policy_lookup_cache.get(key)
    if hit is not None:
        return hit[1]
    shape = ctrls[0].argmin.shape
    strides = np.ones(len(shape), np.int64)
    for k in range(len(shape) - 2, -1, -1):
        strides[k] = strides[k + 1] * shape[k + 1]
    tables = np.stack([
        np.asarray(c.forces, np.float32)[np.asarray(c.argmin).reshape(-1)].T
        for c in ctrls])
    # build the whole lookup HOST-side, then ship it in ONE device_put
    # (a per-leaf eager jnp.stack/asarray chain is one dispatch per op)
    affs = [affine_axes(c.axes, host=True) for c in ctrls]
    aff = jax.tree.map(lambda *xs: np.stack(xs), *affs)
    lookup = jax.device_put(
        _PolicyLookup(tables, aff, strides.astype(np.int32)), device)
    if len(_policy_lookup_cache) >= 8:
        _policy_lookup_cache.pop(next(iter(_policy_lookup_cache)))
    _policy_lookup_cache[key] = (tuple(ctrls), lookup)
    return lookup


# channel -> attitude index: x couples to pitch (t[1]), y to yaw (t[2]),
# z to roll (t[0]) (Solver_pos_att.m:217-233)
_ATT_IDX = np.array([1, 2, 0])


def _lookup_forces(lk: _PolicyLookup, xb, vb, t_ang, w):
    """(3, 4) per-thruster forces for all channels at one 13-state."""
    from ..ops.interp import nearest_cell_index

    att = jnp.asarray(_ATT_IDX)
    q = jnp.stack([xb, vb, t_ang[att], w[att]], axis=-1)      # (3, 4)
    idx = nearest_cell_index(lk.aff, q)                       # (3, 4)
    lin = jnp.sum(idx * lk.strides, axis=-1)                  # (3,)
    return jnp.take_along_axis(lk.tables, lin[:, None, None],
                               axis=2)[:, :, 0]               # (3, 4)


def _rollout_device(device):
    """Resolve the single-flight rollout device.

    ``'auto'`` (default) runs the scan on the HOST CPU backend when the
    default device is an accelerator: one flight's 13-state closed loop
    is a chain of tiny dependent scalar steps, each a kernel launch on a
    GPU. The accelerator is the home of the BATCHED fleet
    (:func:`rollout_batch` stays on the default device). 'cpu'/'default'
    force a backend; a `jax.Device` passes through.
    """
    if device == "auto":
        d0 = jax.devices()[0]
        if d0.platform == "cpu":
            return d0
        return jax.local_devices(backend="cpu")[0]
    if device == "cpu":
        return jax.local_devices(backend="cpu")[0]
    if device == "default" or device is None:
        return jax.devices()[0]
    return device


def get_optimal_path(
    sol: PosAttSolution,
    x0: Optional[jax.Array] = None,
    *,
    t_final: Optional[float] = None,
    use_x_failure: bool = False,
    ode_tol: Optional[float] = None,
    integrator: str = "ode45",
    device="auto",
):
    """Closed-loop 13-state rollout (:452-730) as one on-device scan.

    ``integrator``: 'ode45' (default; Dormand-Prince — the reference
    integrates this plant with ode45, Solver_pos_att.m:504), 'rkf45'
    (Curtis/Fehlberg pair; trajectories agree to integration tolerance,
    tests/test_pos_att.py), or 'rk4' (ONE fixed 4th-order step per 5 ms
    stage — no adaptive while_loops; the serving mode). ``ode_tol=None``
    keeps each adaptive pair's reference defaults (ode45: MATLAB
    RelTol=1e-3/AbsTol=1e-6; rkf45: the Curtis 1e-8); an explicit value
    sets rkf45's tol, or ode45's RelTol with AbsTol at MATLAB's default
    1e-3 ratio.

    ``device='auto'``: the single-flight scan runs on the host CPU
    backend (sequential scalar work; see :func:`_rollout_device`);
    trajectories agree with the accelerator run to backend FMA rounding.

    Returns (T, X, F_th, FM): times (N,), states (N, 13), thruster forces
    (N-1, 12), and the force/moment log (N-1, 6) = [a_rsw (3), U_M (3)].
    """
    cfg = sol.config
    h = cfg.h
    n = cfg.n_stage if t_final is None else int(np.ceil(t_final / h))
    R0, V0 = target_orbit_R0V0()
    ctrls = [sol.controllers["x_failure" if ch == "x" and use_x_failure
                             else ch] for ch in CHANNELS]
    dev = _rollout_device(device)
    lookup = _build_policy_lookup(ctrls, dev)
    y0 = default_x0() if x0 is None else np.asarray(x0, np.float32)
    with jax.default_device(dev):
        return _closed_loop(
            lookup, y0,
            np.asarray(R0, np.float32), np.asarray(V0, np.float32),
            np.asarray(cfg.inertia_matrix, np.float32),
            np.asarray(np.linalg.inv(cfg.inertia_matrix), np.float32),
            n=n, h=h, arm=cfg.moment_arm, mass=cfg.mass,
            accel_scale=cfg.accel_scale, integrator=integrator,
            ode_tol=ode_tol)


def _closed_loop_impl(lookup, y0, R0, V0, inertia, inertia_inv, *, n, h,
                      arm, mass, accel_scale, integrator, ode_tol):
    """The 13-state scan behind :func:`get_optimal_path`.

    Jitted module-level (``_closed_loop``) so repeated rollouts from
    different initial conditions — the receding-horizon replanning pattern —
    reuse the traced/compiled scan. The per-step policy query is ONE fused
    affine locate + one row gather per channel (:func:`_lookup_forces`);
    a searchsorted chain per axis is a long run of sequential scalar ops
    per step."""
    from ..utils.integrators import integrator_kwargs

    _adaptive, _kw = integrator_kwargs(integrator, ode_tol)

    def step(carry, k):
        y = carry
        dr, dv, q, w = y[0:3], y[3:6], y[6:10], y[10:13]
        t_ang = small_angles_from_quat(q)
        xb = rsw_to_body(dr, q, R0, V0)
        vb = rsw_to_body(dv, q, R0, V0)

        forces = _lookup_forces(lookup, xb, vb, t_ang, w)
        fx, fy, fz = forces[0], forces[1], forces[2]

        # moments (to_Moments_Forces, :804-813)
        U_M = jnp.stack([
            (fz[0] - fz[1] + fz[2] - fz[3]) * arm,   # about x
            (fx[0] - fx[1] + fx[2] - fx[3]) * arm,   # about y
            (fy[0] - fy[1] + fy[2] - fy[3]) * arm,   # about z
        ])
        a_body = jnp.stack([jnp.sum(fx), jnp.sum(fy), jnp.sum(fz)]) / mass
        a_rsw = body_to_rsw(a_body, q, R0, V0) * accel_scale

        def rates(tt, yy):
            trans = cw_relative_rates(tt, yy[0:6], a_rsw, R0, V0)
            qdot = quat_kinematics(yy[6:10], yy[10:13])
            # float32 matvecs at full precision (a GPU may use TF32)
            w_ = yy[10:13]
            wdot = jnp.dot(inertia_inv, U_M - jnp.cross(
                w_, jnp.dot(inertia, w_, precision=_HI)), precision=_HI)
            return jnp.concatenate([trans, qdot, wdot])

        t0 = k * h
        y_next = _adaptive(rates, t0, t0 + h, y, **_kw)
        f12 = jnp.concatenate([fx[:2], fy[:2], fz[:2], fx[2:], fy[2:], fz[2:]])
        return y_next, (y, f12, jnp.concatenate([a_rsw, U_M]))

    y_fin, (X, F_th, FM) = jax.lax.scan(step, y0, jnp.arange(n - 1))
    X = jnp.concatenate([X, y_fin[None]], axis=0)
    T = jnp.arange(n) * h
    return T, X, F_th, FM


_closed_loop = partial(
    jax.jit, static_argnames=("n", "h", "arm", "mass", "accel_scale",
                              "integrator", "ode_tol"))(_closed_loop_impl)


@partial(jax.jit, static_argnames=("n", "h", "arm", "mass", "accel_scale",
                                   "integrator", "ode_tol"))
def _closed_loop_batch(lookup, y0s, R0, V0, inertia, inertia_inv, *, n, h,
                       arm, mass, accel_scale, integrator, ode_tol):
    def one(y0):
        return _closed_loop_impl(
            lookup, y0, R0, V0, inertia, inertia_inv, n=n, h=h, arm=arm,
            mass=mass, accel_scale=accel_scale, integrator=integrator,
            ode_tol=ode_tol)

    return jax.vmap(one)(y0s)


def rollout_batch(
    sol: PosAttSolution,
    x0s,
    *,
    t_final: Optional[float] = None,
    use_x_failure: bool = False,
    ode_tol: Optional[float] = None,
    integrator: str = "rk4",
):
    """A fleet of closed-loop rollouts in ONE dispatch — the accelerator's
    serving shape.

    ``x0s``: (B, 13) initial states; the whole batch flies through one
    vmapped scan, so the per-step fixed costs (policy locate, frame
    transforms, integrator step) amortize across the batch — per-trajectory
    throughput scales with B until the (B, 16)-row policy gathers saturate
    HBM. The reference can only loop ``get_optimal_path`` one x0 at a time
    (Solver_pos_att.m:452-506). Default integrator is the fixed-step 'rk4'
    serving mode; the adaptive pairs vmap too (each batch lane steps until
    all lanes accept).

    Returns (T, X, F_th, FM) with a leading batch dim on X/F_th/FM:
    T (N,), X (B, N, 13), F_th (B, N-1, 12), FM (B, N-1, 6).
    """
    cfg = sol.config
    h = cfg.h
    n = cfg.n_stage if t_final is None else int(np.ceil(t_final / h))
    R0, V0 = target_orbit_R0V0()
    ctrls = [sol.controllers["x_failure" if ch == "x" and use_x_failure
                             else ch] for ch in CHANNELS]
    lookup = _build_policy_lookup(ctrls)
    y0s = np.asarray(x0s, np.float32)
    if y0s.ndim != 2 or y0s.shape[-1] != 13:
        raise ValueError(f"x0s must be (B, 13), got {y0s.shape}")
    T, X, F_th, FM = _closed_loop_batch(
        lookup, y0s,
        np.asarray(R0, np.float32), np.asarray(V0, np.float32),
        np.asarray(cfg.inertia_matrix, np.float32),
        np.asarray(np.linalg.inv(cfg.inertia_matrix), np.float32),
        n=n, h=h, arm=cfg.moment_arm, mass=cfg.mass,
        accel_scale=cfg.accel_scale, integrator=integrator, ode_tol=ode_tol)
    return T[0], X, F_th, FM


def receding_horizon(
    x0,
    cfg: Optional[PosAttConfig] = None,
    *,
    sol: Optional[PosAttSolution] = None,
    t_final: Optional[float] = None,
    impl: str = "auto",
    include_failure: bool = False,
):
    """High-resolution coupled solve + closed-loop rollout from arbitrary x0
    (BASELINE.json config #5). ``include_failure`` solves the thruster-0
    failure x controller AND flies the rollout on it (Solver_pos_att.m:
    236-240 failure family).

    For this stationary infinite-horizon problem the converged channel
    policies ARE the receding-horizon controller: the optimal action is
    re-queried from the current 13-state at every step of the closed loop
    (the reference's ``get_optimal_path`` pattern, Solver_pos_att.m:484-506,
    generalized to any x0 / horizon). Pass ``sol`` to reuse solved
    controllers across initial conditions — the policy is x0-independent,
    so replanning costs only the rollout.

    Returns ``(sol, (T, X, F_th, FM))``.
    """
    if sol is None:
        if cfg is None:
            cfg = PosAttConfig.high_res()
        sol = solve(cfg, include_failure=include_failure, impl=impl)
    traj = get_optimal_path(sol, np.asarray(x0, np.float32),
                            t_final=t_final,
                            use_x_failure=include_failure)
    return sol, traj
