"""Kirk ch.3 discrete LQ regulator solved by DP (the golden parity problem).

Re-designs ``test/Dynamic_Solver.m`` for JAX: the state x action grid is a
``(dx, dx, du)`` broadcast, the backup is the fused interp+cost+argmin op, the
stage loop is one ``lax.scan``, and the rollout is a second scan — the entire
solve+rollout compiles to two XLA computations.

Reference constants (test/Dynamic_Solver.m:47-64):
  A = [0.9974 0.0539; -0.1078 1.1591], B = [0.0013; 0.0539],
  Q = diag(0.25, 0.05), R = 0.05, N = 200 stages,
  100x100 state grid on [-2.5, 3]^2, 1000 controls on [-40, 10].
The golden run recorded in test/obj_1.txt uses N=130, dx=35, du=100.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import SolveResult, value_iteration_finite
from ..grids import Grid, linspace_axis
from ..ops import default_impl
from ..ops.interp import InterpPlan, build_plan, interp_eval
from ..ops.stencil import build_stencil_backup

__all__ = ["KirkConfig", "KirkProblem", "KirkSolution", "build", "solve", "optimal_path"]

# impl='auto' on a GPU: the fastest of the three XLA paths at KirkConfig()
# on an H100 80GB at 700 W (basegather 0.8581, sheargather 2.4396, stencil
# 9.6100 ms/sweep; PERF.md)
_GPU_IMPL = "basegather"


@dataclasses.dataclass(frozen=True)
class KirkConfig:
    A: tuple = ((0.9974, 0.0539), (-0.1078, 1.1591))
    B: tuple = (0.0013, 0.0539)
    Q: tuple = (0.25, 0.05)   # diagonal of Q (test/Dynamic_Solver.m:49)
    R: float = 0.05
    N: int = 200              # stages
    dx: int = 100             # state grid points per axis
    du: int = 1000            # control grid points
    x_min: float = -2.5
    x_max: float = 3.0
    u_min: float = -40.0
    u_max: float = 10.0

    @staticmethod
    def golden() -> "KirkConfig":
        """The saved golden-run configuration (test/obj_1.txt:1-17)."""
        return KirkConfig(N=130, dx=35, du=100)


class KirkProblem(NamedTuple):
    config: KirkConfig
    grid: Grid
    u_mesh: np.ndarray          # (du,) control values
    plan: InterpPlan            # queries shaped (dx, dx, du)
    stage_cost: jax.Array       # (dx, dx, du) f32


class KirkSolution(NamedTuple):
    problem: KirkProblem
    result: SolveResult

    @property
    def u_star(self) -> jax.Array:
        """Per-stage optimal-control tables, reference layout.

        ``u_star[k]`` is the table for forward stage ``k`` (0-based,
        k = 0..N-2), i.e. the reference's ``u_star(:,:,k+1)``
        (test/Dynamic_Solver.m:100: sweep k writes slot N-k).
        """
        u = jnp.asarray(self.problem.u_mesh, jnp.float32)
        return u[self.result.policies.astype(jnp.int32)][::-1]


def build(config: KirkConfig = KirkConfig()) -> KirkProblem:
    """Grid + next-state queries + stage cost, all precomputed once.

    Next-state tensors mirror ``a_D_M`` (test/Dynamic_Solver.m:184-188):
    ``x' = A x + B u`` broadcast over the (x1, x2, u) grid. Stage cost mirrors
    ``g_D`` (:196-200): ``Q11 x1^2 + Q22 x2^2 + R u^2``.

    The eager precompute runs PINNED to the host CPU backend (the shared
    build pattern — dozens of tiny eager ops would each be a separate
    device dispatch; the solve jit transfers the finished arrays).
    """
    s_r = linspace_axis(config.x_min, config.x_max, config.dx)
    u_mesh = linspace_axis(config.u_min, config.u_max, config.du)
    grid = Grid((s_r, s_r))

    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        x1 = jnp.asarray(s_r)[:, None, None]
        x2 = jnp.asarray(s_r)[None, :, None]
        u = jnp.asarray(u_mesh)[None, None, :]
        (a11, a12), (a21, a22) = config.A
        b1, b2 = config.B
        x1n = a11 * x1 + a12 * x2 + b1 * u
        x2n = a21 * x1 + a22 * x2 + b2 * u
        plan = build_plan(grid.axes, (x1n, x2n))
        # g_D associates as (Q1 x1^2 + Q2 x2^2) + R u^2
        # (test/Dynamic_Solver.m:196-200)
        q1, q2 = config.Q
        stage_cost = ((q1 * x1**2 + q2 * x2**2).astype(jnp.float32)
                      + (config.R * u**2).astype(jnp.float32))
        stage_cost = jnp.broadcast_to(
            stage_cost, (config.dx, config.dx, config.du)).astype(jnp.float32)
    return KirkProblem(config, grid, u_mesh, plan, stage_cost)


def solve(
    config: KirkConfig = KirkConfig(),
    *,
    store_policies: bool = True,
    impl: str = "auto",
    verbose: bool = False,
) -> KirkSolution:
    """Run the N-1 backward sweeps (test/Dynamic_Solver.m:86-102) under jit.

    ``impl``: ``"auto"`` (default — on a GPU the fastest of the XLA paths
    there, ``_GPU_IMPL``; the XLA stencil on CPU), or explicitly
    ``"stencil"`` (gather-free banded backup — works everywhere),
    ``"sheargather"`` (the shear kernel's XLA form), ``"basegather"``
    (residual-tap gather for wide action sets), or ``"gather"`` (generic
    2^d-corner gather oracle). All compute the same multilinear-
    interpolation + first-min semantics; values agree to f32 rounding.

    ``verbose``: per-stage 'step %d - %f seconds' prints (the reference's
    default console output, test/Dynamic_Solver.m:87,101) via
    profiling.SweepTimer — costs a host callback per sweep.
    """
    problem = build(config)
    from ..profiling import sweep_callback

    on_sweep = sweep_callback(verbose)
    if impl == "auto":
        impl = default_impl(_GPU_IMPL)
    def _chunk():
        return (config.du if config.du <= 64
                else _largest_divisor_leq(config.du, 50))

    backup = None
    if impl == "stencil":
        backup = build_stencil_backup(problem.plan, problem.stage_cost,
                                      action_chunk=_chunk())
    elif impl == "basegather":
        from ..ops.basegather import build_basegather_backup

        backup = build_basegather_backup(problem.plan, problem.stage_cost,
                                         action_chunk=_chunk())
    elif impl == "sheargather":
        from ..ops.sheargather import build_sheargather_backup

        backup = _build_shear_walkdown(build_sheargather_backup, problem,
                                       config.du)
    elif impl != "gather":
        raise ValueError(f"unknown impl {impl!r}")

    if backup is not None and getattr(backup, "traced_argument", False):
        # big off/frac/cost stacks ride as inputs, not compile constants
        @partial(jax.jit, static_argnames=("num_sweeps", "store"))
        def _solve_arg(plan, cost, bk, num_sweeps, store):
            return value_iteration_finite(
                plan, cost, num_sweeps, store_policies=store, backup=bk,
                on_sweep=on_sweep,
            )

        result = _solve_arg(problem.plan, problem.stage_cost, backup,
                            config.N - 1, store_policies)
        return KirkSolution(problem, result)

    @partial(jax.jit, static_argnames=("num_sweeps", "store"))
    def _solve(plan, cost, num_sweeps, store):
        # backup closed over -> weight stacks become foldable constants
        return value_iteration_finite(
            plan, cost, num_sweeps, store_policies=store, backup=backup,
            on_sweep=on_sweep,
        )

    result = _solve(problem.plan, problem.stage_cost, config.N - 1,
                    store_policies)
    return KirkSolution(problem, result)


def _build_shear_walkdown(build_fn, problem, du: int, start: int = 20):
    """Shear-path chunk heuristic: the band must cover WITHIN-chunk action
    drift (inter-chunk drift rides the window), and coarser grids drift
    more cells per control step — walk the chunk down until the band fits
    (golden 35x35x100 needs chunk<=10)."""
    from ..ops.sheargather import ShearBandError

    chunk = du if du <= start else _largest_divisor_leq(du, start)
    while True:
        try:
            return build_fn(problem.plan, problem.stage_cost,
                            action_chunk=chunk)
        except ShearBandError:
            # only band/scratch failures shrink the chunk; any other
            # ValueError (a non-2-D plan) propagates
            if chunk == 1:
                raise
            chunk = _largest_divisor_leq(du, chunk // 2)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def optimal_path(
    sol: KirkSolution,
    x0=(2.0, 1.0),
    *,
    mode: str = "Nssu",
    ssu_num: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Forward rollout (test/Dynamic_Solver.m:108-181) as one ``lax.scan``.

    Per stage: linear-interpolate the stage's u* table at the current state,
    then take the exact LTI step ``x' = A x + B u``. ``mode='ssu'`` replays
    the fixed stage-``ssu_num`` policy table at every step (the reference's
    steady-state-u experiment, :127-131).

    Returns (X, U): X is (N, 2) states, U is (N-1,) controls.

    Runs on the host CPU backend (the single-flight routing of pos_att: a
    199-step sequential scan of tiny steps; the per-stage policy tables
    are a few MB, pulled once).
    """
    from .pos_att import _rollout_device

    cfg = sol.problem.config
    axes = sol.problem.grid.axes
    with jax.default_device(_rollout_device("auto")):
        u_star = jnp.asarray(np.asarray(sol.u_star))  # (N-1, dx, dx)
        A = jnp.asarray(cfg.A, jnp.float32)
        B = jnp.asarray(cfg.B, jnp.float32)

        if mode == "ssu":
            tables = jnp.broadcast_to(u_star[ssu_num], u_star.shape)
        else:
            tables = u_star

        def step(x, table):
            u = interp_eval(table, axes, (x[0], x[1]))
            x_next = jnp.dot(A, x, precision=jax.lax.Precision.HIGHEST) \
                + B * u
            return x_next, (x, u)

        x0 = jnp.asarray(x0, jnp.float32)
        x_final, (X, U) = jax.lax.scan(step, x0, tables)
        X = jnp.concatenate([X, x_final[None]], axis=0)
    return X, U
