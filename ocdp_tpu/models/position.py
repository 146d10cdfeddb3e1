"""Translational position control: 3 decoupled double-integrator channels.

JAX re-design of ``position-control/Solver_position.m``: each body axis is an
independent (x, v) problem with on/off/reverse thrust; the reference solves
the three channels serially (:109-141) — here they are one extra leading
*channel axis* of the state grid, so a single fused backup sweeps all
channels at once (the "expert-parallel" analog of SURVEY.md §2.5), and the
same stencil/gather kernels and sharding layer apply unchanged.

Reference semantics preserved (with file:line cites):
* ``sym_linspace`` grids with an exact 0 point, 200 -> 201 points
  (Solver_position.m:363-371 via :97-104).
* Per-step next states (:152-187): v' = v + h*u/M exactly; x' = x + h*v*c_h
  where c_h = 1 + h/2 + h^2/6 + h^3/24 — the reference's RK4_x feeds the
  integrated variable back as its own derivative argument, which amounts to
  integrating dx/dt = v*e^t; we reproduce the resulting coefficient when
  ``rk4_x_parity=True`` (default) and use the exact x' = x + h*v otherwise.
* Quadratic stage cost Qx*x^2 + Qv*v^2 + R*u^2 (:113-121).
* 6000-sweep value iteration, steady-state policy = final argmin wrapped as
  a 'nearest' interpolant (:131-146).
* Closed-loop rollout against relative orbital motion about an eccentric
  target (:189-311) with RKF45 between stages; the policy output (thruster
  FORCE, N) is added directly to the km-based CW accelerations — the
  reference's unit quirk (:216-220 + :304-306) — controlled by
  ``accel_scale`` (default 1.0 = reference behavior; set 1e-3/Mass for
  physical m/s^2 -> km/s^2).
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
from ..engine import SolveResult, value_iteration_finite
from ..grids import Grid, sym_linspace_inclusive
from ..ops.interp import build_plan, nearest_eval
from ..ops.stencil import build_stencil_backup
from ..utils.integrators import rkf45_integrate

__all__ = ["PositionConfig", "PositionProblem", "PositionSolution", "build",
           "solve", "get_optimal_path"]


@dataclasses.dataclass(frozen=True)
class PositionConfig:
    # grid (Solver_position.m:49-56)
    x_min: float = -0.5
    x_max: float = 0.5
    v_min: float = -0.5
    v_max: float = 0.5
    n_mesh_x: int = 200
    n_mesh_v: int = 200
    # plant (:58, :84)
    mass: float = 4.16
    thrust: float = 0.26
    # cost, per channel (:61-69)
    Qx: tuple = (6.0, 6.0, 6.0)
    Qv: tuple = (6.0, 6.0, 6.0)
    R: tuple = (0.1, 0.1, 0.1)
    # horizon (:71-72)
    T_final: float = 30.0
    h: float = 0.005
    # parity knobs (see module docstring)
    rk4_x_parity: bool = True
    accel_scale: float = 1.0

    def __post_init__(self):
        # reference guard rail: warn (and ceil) when T_final/h is not an
        # integer stage count (Solver_position.m:77-81)
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

    @property
    def u_vector(self) -> np.ndarray:
        return np.array([-self.thrust, 0.0, self.thrust], np.float32)

    @property
    def n_channels(self) -> int:
        return len(self.Qx)


class PositionProblem(NamedTuple):
    config: PositionConfig
    grid: Grid            # (channel, x, v) axes
    plan: object          # InterpPlan, queries (C, nx, nv, nu)
    stage_cost: jax.Array


class PositionSolution(NamedTuple):
    problem: PositionProblem
    result: SolveResult

    @property
    def u_tables(self) -> jax.Array:
        """(C, nx, nv) optimal thrust force per channel (steady-state policy)."""
        u = jnp.asarray(self.problem.config.u_vector)
        return u[self.result.argmin]


def _x_step_coeff(h: float, parity: bool) -> float:
    if not parity:
        return 1.0
    return 1.0 + h / 2 + h**2 / 6 + h**3 / 24


def build(config: PositionConfig = PositionConfig()) -> PositionProblem:
    cfg = config
    s_x = sym_linspace_inclusive(cfg.x_min, cfg.x_max, cfg.n_mesh_x)
    s_v = sym_linspace_inclusive(cfg.v_min, cfg.v_max, cfg.n_mesh_v)
    chan = np.arange(cfg.n_channels, dtype=np.float32)
    grid = Grid((chan, s_x, s_v))

    # broadcast-shaped queries over (channel, x, v, u); channel never
    # moves. PINNED to the host CPU backend (the shared build pattern —
    # dozens of tiny eager ops would each be a separate device dispatch)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        c = jnp.asarray(chan)[:, None, None, None]
        x = jnp.asarray(s_x)[None, :, None, None]
        v = jnp.asarray(s_v)[None, None, :, None]
        u = jnp.asarray(cfg.u_vector)[None, None, None, :]

        x_next = x + cfg.h * v * _x_step_coeff(cfg.h, cfg.rk4_x_parity)
        v_next = v + cfg.h * u / cfg.mass
        plan = build_plan(grid.axes, (c, x_next, v_next))

        Qx = jnp.asarray(cfg.Qx, jnp.float32)[:, None, None, None]
        Qv = jnp.asarray(cfg.Qv, jnp.float32)[:, None, None, None]
        R = jnp.asarray(cfg.R, jnp.float32)[:, None, None, None]
        stage_cost = Qx * x**2 + Qv * v**2 + R * u**2
    return PositionProblem(cfg, grid, plan, stage_cost)


def solve(
    config: PositionConfig = PositionConfig(),
    *,
    num_sweeps: Optional[int] = None,
    impl: str = "auto",
    verbose: bool = False,
) -> PositionSolution:
    """All channels' value iteration in one jitted scan (:131-141).

    ``verbose``: per-stage 'step %d - %f seconds' prints (the reference's
    default console output) via profiling.SweepTimer."""
    problem = build(config)
    from ..profiling import sweep_callback

    on_sweep = sweep_callback(verbose)
    sweeps = (config.n_stage - 1) if num_sweeps is None else num_sweeps
    backup = None
    if impl in ("stencil", "auto"):
        # the XLA stencil serves every backend here (position batches its
        # channels as a 3rd grid axis)
        backup = build_stencil_backup(problem.plan, problem.stage_cost)
    elif impl != "gather":
        raise ValueError(
            f"unknown impl {impl!r} (position supports 'auto'/'stencil'/"
            f"'gather')")

    @partial(jax.jit, static_argnames=("n",))
    def _solve(plan, cost, n):
        # backup closed over -> weight stacks become foldable constants
        return value_iteration_finite(plan, cost, n, store_policies=False,
                                      backup=backup, on_sweep=on_sweep)

    result = _solve(problem.plan, problem.stage_cost, sweeps)
    return PositionSolution(problem, result)


def get_optimal_path(
    sol: PositionSolution,
    y0=(-1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    *,
    t_final: Optional[float] = None,
    ode_tol: float = 1e-8,
    device="auto",
):
    """Closed-loop rollout vs. the eccentric-target relative-motion plant.

    One ``lax.scan`` over stages (Solver_position.m:210-225): per stage a
    'nearest' policy lookup per channel, then RKF45 integration of the CW
    equations with the target propagated by universal-variable Kepler.

    ``device='auto'`` runs the scan on the host CPU backend when the
    default device is an accelerator — a single flight is sequential
    scalar work, and the adaptive RKF45 while_loops are chains of tiny
    dependent steps (same routing as pos_att.get_optimal_path). The jitted
    scan is module-level, so repeated rollouts reuse one compile.

    Returns (T, X, U): times (N,), states (N, 6), controls (N-1, 3).
    """
    from .pos_att import _rollout_device

    cfg = sol.problem.config
    axes = tuple(np.asarray(a) for a in sol.problem.grid.axes[1:])  # (x, v)
    h = cfg.h
    n = cfg.n_stage if t_final is None else int(np.ceil(t_final / h))
    R0, V0 = target_orbit_R0V0()
    dev = _rollout_device(device)
    tables = jax.device_put(np.asarray(sol.u_tables), dev)  # (C, nx, nv)
    with jax.default_device(dev):
        return _position_closed_loop(
            tables, _HashableAxes(axes), np.asarray(y0, np.float32),
            np.asarray(R0, np.float32), np.asarray(V0, np.float32),
            n=n, h=h, accel_scale=cfg.accel_scale, ode_tol=ode_tol)


class _HashableAxes:
    """Small grid axes as a hashable static jit argument."""

    def __init__(self, arrays):
        self.arrays = tuple(np.asarray(a) for a in arrays)
        self._key = tuple((a.shape, a.dtype.str, a.tobytes())
                          for a in self.arrays)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, _HashableAxes) and self._key == other._key


@partial(jax.jit, static_argnames=("axes", "n", "h", "accel_scale",
                                   "ode_tol"))
def _position_closed_loop(tables, axes, y0, R0, V0, *, n, h, accel_scale,
                          ode_tol):
    """The scan behind :func:`get_optimal_path`, one cached module-level
    jit (``axes`` ride static as hashable tuples-of-bytes via
    ``_HashableAxes`` — they are small host constants)."""
    ax = tuple(jnp.asarray(a) for a in axes.arrays)

    def policy(y):
        a = [nearest_eval(tables[i], ax, (y[i], y[3 + i])) for i in range(3)]
        return jnp.stack(a) * accel_scale

    def step(carry, k):
        y = carry
        t = k * h
        accel = policy(y)
        f = lambda tt, yy: cw_relative_rates(tt, yy, accel, R0, V0)  # noqa: E731
        y_next = rkf45_integrate(f, t, t + h, y, tol=ode_tol)
        return y_next, (y, accel)

    y_fin, (X, U) = jax.lax.scan(step, jnp.asarray(y0, jnp.float32),
                                 jnp.arange(n - 1))
    X = jnp.concatenate([X, y_fin[None]], axis=0)
    T = jnp.arange(n) * h
    return T, X, U
