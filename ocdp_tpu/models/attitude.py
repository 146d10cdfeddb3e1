"""Rigid-body attitude control (Solver_attitude): per-axis simplified DP and
the full coupled 6-D solve, plus rollouts and the PD baseline.

State convention — the reference stores quaternions in "Kirk" component
order [x4 x5 x6 x7] with the load-bearing mapping to MATLAB scalar-first
components documented at Solver_attitude.m:322-340. In terms of this
package's scalar-last [x, y, z, w] (utils/quaternions.py):

    kirk q1 (X4) = z,  kirk q2 (X5) = y,  kirk q3 (X6) = x,  kirk q4 (X7) = w

so the reference's Euler-angle readback (atan2/asin at :485-489) is exactly
``quat_to_euler_zyx`` under that permutation, and its half-angle quaternion
construction (:449-467) is ``euler_zyx_to_quat``.

Two solvers, as in the reference:

* ``solve_simplified`` — 3 independent (omega_i, theta_i) 2-D problems with
  diagonal-inertia torque dynamics (:196-259). The reference's RK4_t feeds
  omega back through the theta-derivative (same quirk as Solver_position's
  RK4_x), giving theta' = theta + h*omega*(1 + h/2 + h^2/6 + h^3/24);
  reproduced behind ``rk4_t_parity``.
* ``solve_full`` — the coupled 6-D grid (omega1..3, yaw, pitch, roll) with
  27 torque combinations (:261-300). Dynamics: Euler-step omega with
  gyroscopic cross terms, Euler-step the quaternion built from Euler
  half-angles, renormalize, read back to Euler angles (:413-506). The
  nominal mesh (1000^3 x 10^3) is infeasible by design (SURVEY.md §2.8) —
  grid sizes are first-class config; the .asv history ran 11^3 x 10^3.
  The 3-axis chained argmin (:400-409) is one flat first-min argmin here
  (C-order equivalence, see ops/backup.py).

  The row/lane kernel (ops/pallas_backup6.py, impl='rowlane') carries
  the reference's historical 11^3 x 10^3 = 1.33M-cell grid; big grids
  build flat on-device plans in row-block chunks, and parallel/halo6.py
  shards the omega-row axis across a mesh. The XLA stencil
  (impl='stencil') is the portable path.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import SolveResult, value_iteration_finite
from ..grids import Grid, linspace_axis
from ..ops import default_impl
from ..ops.interp import build_plan, interp_eval, nearest_eval
from ..ops.stencil import build_stencil_backup
from ..utils.integrators import rk4_step
from ..utils.quaternions import quat_to_euler_zyx

__all__ = [
    "AttitudeConfig",
    "decode_torque_digits",
    "solve_simplified",
    "solve_full",
    "rollout_full",
    "rollout_simplified_plant",
    "rollout_simplified_real_dynamics",
    "linear_control_response",
]

_DEG = np.pi / 180.0
_HI = jax.lax.Precision.HIGHEST


def _jit_solve(plan, cost, backup, n, on_sweep=None):
    """Jitted finite-horizon solve.

    Two compile strategies, chosen by the backup's weight mode:
    * onthefly weights -> backup CLOSED OVER: its (off, frac) arrays become
      compile-time constants and XLA constant-folds the weight stacks
      (~40x faster sweeps than tracing them).
    * precomputed weights -> backup passed as a traced ARGUMENT: the dense
      weight stacks are plain inputs (nothing to fold), and keeping them out
      of the executable avoids blowing the remote-compile payload limit on
      big grids.
    """
    if backup is not None and (getattr(backup, "weights", ())
                               or getattr(backup, "traced_argument", False)):
        @partial(jax.jit, static_argnames=("n",))
        def go_arg(plan, cost, backup, n):
            return value_iteration_finite(plan, cost, n, store_policies=False,
                                          backup=backup, on_sweep=on_sweep)

        return go_arg(plan, cost, backup, n)

    @partial(jax.jit, static_argnames=("n",))
    def go(plan, cost, n):
        return value_iteration_finite(plan, cost, n, store_policies=False,
                                      backup=backup, on_sweep=on_sweep)

    return go(plan, cost, n)


@dataclasses.dataclass(frozen=True)
class AttitudeConfig:
    # omega grid (Solver_attitude.m:106-108)
    w_min_deg: float = -50.0
    w_max_deg: float = 50.0
    n_mesh_w: int = 1000
    # Euler-angle grids (:109-116)
    yaw_range_deg: tuple = (-30.0, 30.0)
    pitch_range_deg: tuple = (-20.0, 20.0)
    roll_range_deg: tuple = (-35.0, 35.0)
    n_mesh_q: int = 10     # per Euler axis, full solver
    n_mesh_t: int = 300    # per theta axis, simplified solver
    # inertia (:118-126), same SPHERES satellite as pos-att
    inertia_diag: tuple = (0.02836 + 0.00016, 0.026817 + 0.00150, 0.023 + 0.00150)
    inertia_offdiag: tuple = (-0.0000837, 0.000014, -0.00029)
    # cost (:128-141)
    Qw: tuple = (6.0, 6.0, 6.0)
    Qq: tuple = (6.0, 6.0, 6.0)
    R: tuple = (4.0, 4.0, 4.0)
    # horizon (:143-144)
    T_final: float = 30.0
    h: float = 0.005
    # torques (:174)
    u_max: float = 0.11
    # parity knob (module docstring)
    rk4_t_parity: bool = True

    def __post_init__(self):
        # reference guard rail: warn (and ceil) when T_final/h is not an
        # integer stage count (Solver_attitude.m:151-155)
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
        return np.array([-self.u_max, 0.0, self.u_max], np.float32)

    @property
    def inertia_matrix(self) -> np.ndarray:
        d, o = self.inertia_diag, self.inertia_offdiag
        return np.array([[d[0], o[0], o[1]],
                         [o[0], d[1], o[2]],
                         [o[1], o[2], d[2]]])

    @property
    def euler_ranges(self):
        return (tuple(np.asarray(self.yaw_range_deg) * _DEG),
                tuple(np.asarray(self.pitch_range_deg) * _DEG),
                tuple(np.asarray(self.roll_range_deg) * _DEG))

    @staticmethod
    def default_x0() -> jnp.ndarray:
        """[w; kirk-q] with q = angle2quat(5, 10, -9 deg) (:160-163)."""
        from ..utils.quaternions import kirk_quat_from_euler

        kirk = kirk_quat_from_euler(jnp.asarray(5 * _DEG),
                                    jnp.asarray(10 * _DEG),
                                    jnp.asarray(-9 * _DEG))
        return jnp.concatenate([jnp.zeros(3), kirk]).astype(jnp.float32)


def _quirk(h: float, on: bool) -> float:
    return (1.0 + h / 2 + h * h / 6 + h**3 / 24) if on else 1.0


# ---------------------------------------------------------------- simplified

class SimplifiedSolution(NamedTuple):
    config: AttitudeConfig
    axes: tuple       # per channel: (s_w, s_t)
    u_tables: tuple   # per channel: (n_mesh_w, n_mesh_t) torque table
    values: tuple
    # The out-of-grid value policy this solve actually used. Recorded
    # because the DEFAULT ('clamp') deliberately deviates from reference
    # parity (MATLAB extrapolates) at edge cells while solve_full defaults
    # to 'extrapolate' — parity comparisons against the reference should
    # check this field instead of assuming.
    edge: str = "clamp"


def solve_simplified(
    cfg: AttitudeConfig = AttitudeConfig(),
    *,
    num_sweeps: Optional[int] = None,
    impl: str = "auto",
    edge: str = "clamp",
    verbose: bool = False,
    interpret: bool = False,
) -> SimplifiedSolution:
    """3 decoupled (omega, theta) solves (:196-259), one jit each.

    ``impl='auto'`` picks the row-band backup, falling back to the stencil
    when the grid/dynamics don't factor into row bands;
    ``'rowband'``/``'stencil'``/``'rowlane'``/``'gather'`` force a path.
    ``interpret`` runs the row/lane kernel in the Pallas interpreter
    (CPU tests).

    ``edge='clamp'`` (default) projects out-of-grid next states onto the
    grid boundary, which keeps value iteration unconditionally stable;
    ``edge='extrapolate'`` is strict reference parity
    (Solver_attitude.m:268-270 never clamps) but the reference's own
    semantics DIVERGE at edge cells whose dynamics exit the omega grid once
    f32 rounding flips their argmin — observed with every backup impl
    (including the gather oracle) at the reference's 5999-sweep horizon.
    Interior cells are identical under both policies. See
    :func:`ocdp_tpu.ops.interp.build_plan`.

    ``verbose``: per-stage 'step %d - %f seconds' prints (the reference's
    default console output) via profiling.SweepTimer."""
    sweeps = (cfg.n_stage - 1) if num_sweeps is None else num_sweeps
    from ..profiling import sweep_callback

    on_sweep = sweep_callback(verbose)
    auto = impl == "auto"
    if auto:
        impl = "rowband"
    c_h = _quirk(cfg.h, cfg.rk4_t_parity)
    axes_out, tables, values = [], [], []
    for i, (t_lo, t_hi) in enumerate(cfg.euler_ranges):
        s_w = linspace_axis(cfg.w_min_deg * _DEG, cfg.w_max_deg * _DEG, cfg.n_mesh_w)
        s_t = linspace_axis(t_lo, t_hi, cfg.n_mesh_t)
        grid = Grid((s_w, s_t))
        J = cfg.inertia_diag[i]
        w = jnp.asarray(s_w)[:, None, None]
        t = jnp.asarray(s_t)[None, :, None]
        u = jnp.asarray(cfg.u_vector)[None, None, :]
        w_next = w + cfg.h * u / J        # RK4_w: k's equal (:631-645)
        t_next = t + cfg.h * w * c_h      # RK4_t quirk (:647-661)
        plan = build_plan(grid.axes, (w_next, t_next), edge=edge)
        cost = cfg.Qw[i] * w**2 + cfg.Qq[i] * t**2 + cfg.R[i] * u**2

        backup = None
        if impl == "rowband":
            from ..ops.rowband import RowBandStructureError, build_rowband_backup

            try:
                backup = build_rowband_backup(plan, cost)
            except RowBandStructureError:
                if not auto:
                    raise
                backup = build_stencil_backup(plan, cost)
        elif impl == "stencil":
            backup = build_stencil_backup(plan, cost)
        elif impl == "rowlane":
            # (omega, theta) is row/lane separable as-is: omega' dep
            # (omega, u) = action-coupled row; theta' dep (theta, omega) =
            # action-independent lane — the same kernel that carries the
            # 6-D grid (ops/pallas_backup6.py), here at 2-D
            from ..ops.pallas_backup6 import build_pallas_backup_6d

            backup = build_pallas_backup_6d(
                plan, [cfg.Qw[i] * w**2, cfg.Qq[i] * t**2,
                       cfg.R[i] * u**2], row_axes=1, interpret=interpret)
        elif impl != "gather":
            raise ValueError(f"unknown impl {impl!r}")

        res = _jit_solve(plan, cost, backup, sweeps, on_sweep)
        axes_out.append((s_w, s_t))
        tables.append(jnp.asarray(cfg.u_vector)[res.argmin])
        values.append(res.values)
    return SimplifiedSolution(cfg, tuple(axes_out), tuple(tables),
                              tuple(values), edge)


# ----------------------------------------------------------------- full 6-D

def decode_torque_digits(a, u_vec):
    """Flat 27-action argmin -> (u1, u2, u3) per-axis torques.

    The 3-digit C-order decode behind the reference's nested-index
    composition U3(U2(U1)), U2(U1) (Solver_attitude.m:290-292; flat
    equivalence proven in ops/backup.py). Array-namespace agnostic:
    numpy in / numpy out (host-side envelope decodes), jnp in / jnp out
    (on-device tables and rollout lookups)."""
    nu = len(u_vec)
    i1, rem = a // (nu * nu), a % (nu * nu)
    return u_vec[i1], u_vec[rem // nu], u_vec[rem % nu]


class FullSolution(NamedTuple):
    config: AttitudeConfig
    grid: Grid
    result: SolveResult

    @property
    def is_flat(self) -> bool:
        """True when the result tables are in the flat (rows, lanes) device
        layout (envelope-scale solves: flat plans / padded-carry engine)."""
        return np.ndim(self.result.argmin) != self.grid.ndim

    @property
    def u_tables(self):
        """(3, *state_shape) optimal torque per axis from the flat argmin.

        Equivalent to the reference's nested-index composition
        U3(U2(U1)), U2(U1) (:290-292) — see ops/backup.py.

        Envelope-scale solves (flat plans / padded-carry engine) hold
        ``result.argmin`` in the flat (rows, lanes) device layout; decoding
        those to 6-D ON DEVICE would re-materialize the ~8x tile padding the
        flat layout exists to avoid (three f32 tables ~12 GB padded at 1B
        cells), so flat results decode HOST-side from ``argmin_6d()`` and
        return numpy. (``rollout_full`` never needs this for flat results —
        it queries the flat argmin directly on device.) Small non-flat
        solves keep the on-device decode.
        """
        if self.is_flat:
            return np.stack(decode_torque_digits(
                self.argmin_6d(), np.asarray(self.config.u_vector)))
        return jnp.stack(decode_torque_digits(
            self.result.argmin.reshape(self.grid.shape),
            jnp.asarray(self.config.u_vector)))

    def values_6d(self) -> np.ndarray:
        """HOST-side state-shaped view of the values.

        Envelope-scale solves (>8M cells) return the value table in the
        flat (rows, lanes) device layout — reshaping to 6-D ON DEVICE
        materializes ~8x tile padding on the small trailing dims (the old
        envelope wall); as a numpy reshape it is free."""
        return np.asarray(self.result.values).reshape(self.grid.shape)

    def argmin_6d(self) -> np.ndarray:
        """HOST-side state-shaped view of the flat-action argmin."""
        return np.asarray(self.result.argmin).reshape(self.grid.shape)


# past this many cells the one-shot flat build's transients (~12 table-
# sized arrays live inside one jit) exhaust HBM — chunk over row blocks
_CHUNKED_BUILD_MIN_CELLS = 60_000_000


def build_full(cfg: AttitudeConfig, flat: Optional[bool] = None,
               edge: str = "extrapolate", chunked: Optional[bool] = None,
               block_rows: Optional[int] = None):
    """6-D grid, taylor-estimate next states, quaternion cost (:261-506).

    ``edge``: out-of-grid value policy — 'extrapolate' (strict reference
    parity, default; V stays bounded at the reference config over its full
    horizon — measured) or 'clamp' (boundary projection, unconditionally
    stable; see ops/interp.build_plan).

    Small grids run pinned to the host CPU backend: the precompute is dozens
    of tiny eager broadcast ops, each a separate dispatch (and compile) on
    an accelerator; the solve moves the finished plan/cost to the device
    in one transfer. Big grids (> 8M cells on a GPU) instead run the whole
    precompute as ONE jitted device dispatch, building flat (rows, lanes,
    actions) plan arrays on the device. Past ~60M cells the Euler lo/frac
    arrays are filled in ROW-BLOCK chunks with donated in-place updates
    (``chunked``; auto), so the one-shot jit's ~12 live table-sized
    transients never exist at once.
    """
    s_w = linspace_axis(cfg.w_min_deg * _DEG, cfg.w_max_deg * _DEG, cfg.n_mesh_w)
    (y_lo, y_hi), (p_lo, p_hi), (r_lo, r_hi) = cfg.euler_ranges
    s_yaw = linspace_axis(y_lo, y_hi, cfg.n_mesh_q)
    s_pitch = linspace_axis(p_lo, p_hi, cfg.n_mesh_q)
    s_roll = linspace_axis(r_lo, r_hi, cfg.n_mesh_q)
    grid = Grid((s_w, s_w, s_w, s_yaw, s_pitch, s_roll))
    cells = int(np.prod(grid.shape))
    big = cells > 8_000_000
    on_device = big and jax.default_backend() == "gpu"
    if flat is None:
        flat = on_device
    if chunked is None:
        chunked = on_device and flat and cells > _CHUNKED_BUILD_MIN_CELLS
    if chunked:
        if not flat:
            raise ValueError("chunked build requires the flat layout")
        plan, cost_terms = _plan_and_cost_flat_chunked(
            cfg, grid, s_w, s_yaw, s_pitch, s_roll, edge=edge,
            block_rows=block_rows)
    elif on_device:
        plan, cost_terms = jax.jit(
            lambda: _plan_and_cost(cfg, grid, s_w, s_yaw, s_pitch, s_roll,
                                   flat=flat, edge=edge))()
    else:
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            plan, cost_terms = _plan_and_cost(cfg, grid, s_w, s_yaw,
                                              s_pitch, s_roll, flat=flat,
                                              edge=edge)
    return grid, plan, cost_terms


def plan_is_flat(plan) -> bool:
    """True for plans whose arrays use the flat (rows, lanes, actions)
    layout (big on-device builds) instead of the d-D broadcast layout."""
    return len(plan.query_shape) != plan.ndim + 1



def _kirk_q_from_half_angles(cy, sy, cp, sp, cr, sr):
    """kirk-q components from Euler half-angle cos/sin (:449-467);
    broadcast-shaped. SINGLE SOURCE for both plan builders — the chunked
    envelope path's bit-identity with the one-shot path depends on these
    expressions staying textually shared."""
    q1 = sy * cp * cr - cy * sp * sr
    q2 = cy * sp * cr + sy * cp * sr
    q3 = cy * cp * sr - sy * sp * cr
    q4 = jnp.sqrt(jnp.maximum(1.0 - (q1**2 + q2**2 + q3**2), 0.0))
    return q1, q2, q3, q4


def _omega_euler_step(cfg, w1, w2, w3, u1, u2, u3):
    """Euler-step omega with gyroscopic cross terms (:423-425)."""
    J1, J2, J3 = cfg.inertia_diag
    h = cfg.h
    return (w1 + h * ((J2 - J3) / J1 * w2 * w3 + u1 / J1),
            w2 + h * ((J3 - J1) / J2 * w3 * w1 + u2 / J2),
            w3 + h * ((J1 - J2) / J3 * w1 * w2 + u3 / J3))


def _quat_step_readback(cfg, q, w1, w2, w3):
    """Euler-step kirk-q kinematics (:525-556 / :600-622), renormalize
    (:477-483), Euler-angle readback (:485-489); broadcast-shaped."""
    q1, q2, q3, q4 = q
    h = cfg.h
    q1n = q1 + h * 0.5 * (w3 * q2 - w2 * q3 + w1 * q4)
    q2n = q2 + h * 0.5 * (-w3 * q1 + w1 * q3 + w2 * q4)
    q3n = q3 + h * 0.5 * (w2 * q1 - w1 * q2 + w3 * q4)
    q4n = q4 + h * 0.5 * (-w1 * q1 - w2 * q2 - w3 * q3)
    norm = jnp.sqrt(q1n**2 + q2n**2 + q3n**2 + q4n**2)
    q1n, q2n, q3n, q4n = q1n / norm, q2n / norm, q3n / norm, q4n / norm
    yaw_n = jnp.arctan2(2 * (q3n * q2n + q4n * q1n),
                        q4n**2 + q3n**2 - q2n**2 - q1n**2)
    pitch_n = jnp.arcsin(jnp.clip(-2 * (q3n * q1n - q4n * q2n), -1.0, 1.0))
    roll_n = jnp.arctan2(2 * (q2n * q1n + q4n * q3n),
                         q4n**2 - q3n**2 - q2n**2 + q1n**2)
    return yaw_n, pitch_n, roll_n


def _plan_and_cost(cfg: AttitudeConfig, grid, s_w, s_yaw, s_pitch, s_roll,
                   flat: bool = False, edge: str = "extrapolate"):
    nu = len(cfg.u_vector)

    # broadcast layout: (w1, w2, w3, yaw, pitch, roll, u1, u2, u3) -> flat A
    def bshape(arr, axis):
        sh = [1] * 9
        sh[axis] = -1
        return jnp.asarray(arr).reshape(sh)

    w1, w2, w3 = (bshape(s_w, i) for i in range(3))
    cy, sy = bshape(np.cos(s_yaw / 2), 3), bshape(np.sin(s_yaw / 2), 3)
    cp, sp = bshape(np.cos(s_pitch / 2), 4), bshape(np.sin(s_pitch / 2), 4)
    cr, sr = bshape(np.cos(s_roll / 2), 5), bshape(np.sin(s_roll / 2), 5)
    u1, u2, u3 = (bshape(cfg.u_vector, 6 + i) for i in range(3))

    q1, q2, q3, q4 = _kirk_q_from_half_angles(cy, sy, cp, sp, cr, sr)
    w1n, w2n, w3n = _omega_euler_step(cfg, w1, w2, w3, u1, u2, u3)
    yaw_n, pitch_n, roll_n = _quat_step_readback(cfg, (q1, q2, q3, q4),
                                                 w1, w2, w3)

    # stage cost (:315-342): Qw w^2 + Qq q_vec^2 + R u^2, kept FACTORIZED as
    # broadcast terms — the materialized S x A cost tensor for this problem
    # is O(n_w^3 n_q^3 * 27) and must never exist (SURVEY.md §7: recompute
    # g(x,u) on the fly instead of materializing like MATLAB must).
    cost_terms = (
        cfg.Qw[0] * w1**2 + cfg.Qw[1] * w2**2 + cfg.Qw[2] * w3**2,
        cfg.Qq[0] * q1**2 + cfg.Qq[1] * q2**2 + cfg.Qq[2] * q3**2,
        cfg.R[0] * u1**2 + cfg.R[1] * u2**2 + cfg.R[2] * u3**2,
    )

    if flat:
        # (rows, lanes, actions) layout: rows = flat omega cells, lanes =
        # flat Euler cells, actions = flat C-order torque index
        nmw, nmq = cfg.n_mesh_w, cfg.n_mesh_q
        NW, NE, A = nmw**3, nmq**3, nu**3

        def fw(q):
            q = jnp.broadcast_to(q, (nmw, nmw, nmw, 1, 1, 1, nu, nu, nu))
            return q.reshape(NW, 1, A)

        def fe(q):
            q = jnp.broadcast_to(q, (nmw, nmw, nmw, nmq, nmq, nmq, 1, 1, 1))
            return q.reshape(NW, NE, 1)

        plan = build_plan(grid.axes, (fw(w1n), fw(w2n), fw(w3n),
                                      fe(yaw_n), fe(pitch_n), fe(roll_n)),
                          edge=edge)
        cost_flat = (
            jnp.broadcast_to(cost_terms[0],
                             (nmw,) * 3 + (1,) * 6).reshape(NW, 1, 1),
            jnp.broadcast_to(cost_terms[1],
                             (1, 1, 1) + (nmq,) * 3 + (1,) * 3
                             ).reshape(1, NE, 1),
            jnp.broadcast_to(cost_terms[2],
                             (1,) * 6 + (nu,) * 3).reshape(1, 1, A),
        )
        return plan, cost_flat

    def flat_actions(arr):
        """Broadcast the 3 trailing action axes and flatten to one (C-order:
        u1 slowest, u3 fastest = the reference's chained-min order)."""
        full = jnp.broadcast_to(arr, arr.shape[:6] + (nu, nu, nu)) \
            if arr.shape[6:] != (1, 1, 1) else arr
        if full.shape[6:] == (1, 1, 1):
            return full.reshape(full.shape[:6] + (1,))
        return full.reshape(full.shape[:6] + (nu**3,))

    queries = tuple(flat_actions(q) for q in
                    (w1n, w2n, w3n, yaw_n, pitch_n, roll_n))
    plan = build_plan(grid.axes, queries, edge=edge)
    cost_terms = tuple(flat_actions(t) for t in cost_terms)
    return plan, cost_terms


def _plan_and_cost_flat_chunked(cfg: AttitudeConfig, grid, s_w, s_yaw,
                                s_pitch, s_roll, edge: str = "extrapolate",
                                block_rows: Optional[int] = None):
    """Flat plan built in ROW-BLOCK chunks (envelope scales).

    The one-shot flat build keeps ~12 (NW, NE) f32 transients live inside
    a single jit (quaternion step, renorm, Euler readback, searchsorted
    temps) — at 167M cells that is ~8 GB of transients on top of the 4 GB
    plan (computed). Here the small pieces (omega row arrays, lane
    q components, factorized cost) build in one tiny dispatch, and the six
    Euler lo/frac tables fill block-by-block with donated in-place
    ``dynamic_update_slice`` steps — peak transient = one block's worth.
    Buffers are allocated in their final (NW, NE, 1) plan shape so no
    expand-dims copy ever doubles them at the end. Same arithmetic as
    :func:`_plan_and_cost` (shared helper functions); the last block
    overlaps backward (idempotent rewrite) when ``block_rows`` (default:
    a multiple of n_mesh_w^2 targeting ~0.5 GB of transients; exposed for
    tests) doesn't divide NW.
    """
    from functools import partial as _partial

    from ..ops.interp import axis_locate

    if edge not in ("extrapolate", "clamp"):    # build_plan's validation
        raise ValueError(f"unknown edge policy {edge!r}")
    nu = len(cfg.u_vector)
    nmw, nmq = cfg.n_mesh_w, cfg.n_mesh_q
    NW, NE, A = nmw**3, nmq**3, nu**3

    def small_parts():
        # omega row arrays (NW, 1, A) + lane q components (NE,) + cost
        w1 = jnp.asarray(s_w).reshape(-1, 1, 1, 1, 1, 1)
        w2 = jnp.asarray(s_w).reshape(1, -1, 1, 1, 1, 1)
        w3 = jnp.asarray(s_w).reshape(1, 1, -1, 1, 1, 1)
        u1 = jnp.asarray(cfg.u_vector).reshape(1, 1, 1, -1, 1, 1)
        u2 = jnp.asarray(cfg.u_vector).reshape(1, 1, 1, 1, -1, 1)
        u3 = jnp.asarray(cfg.u_vector).reshape(1, 1, 1, 1, 1, -1)
        w1n, w2n, w3n = _omega_euler_step(cfg, w1, w2, w3, u1, u2, u3)

        def fw(q):
            q = jnp.broadcast_to(q, (nmw,) * 3 + (nu,) * 3)
            return q.reshape(NW, 1, A)

        cy = jnp.cos(jnp.asarray(s_yaw) / 2).reshape(-1, 1, 1)
        sy = jnp.sin(jnp.asarray(s_yaw) / 2).reshape(-1, 1, 1)
        cp = jnp.cos(jnp.asarray(s_pitch) / 2).reshape(1, -1, 1)
        sp = jnp.sin(jnp.asarray(s_pitch) / 2).reshape(1, -1, 1)
        cr = jnp.cos(jnp.asarray(s_roll) / 2).reshape(1, 1, -1)
        sr = jnp.sin(jnp.asarray(s_roll) / 2).reshape(1, 1, -1)
        q1, q2, q3, q4 = (q.reshape(NE) for q in
                          _kirk_q_from_half_angles(cy, sy, cp, sp, cr, sr))

        c_row = (cfg.Qw[0] * w1**2 + cfg.Qw[1] * w2**2
                 + cfg.Qw[2] * w3**2)
        c_row = jnp.broadcast_to(c_row, (nmw,) * 3 + (1,) * 3).reshape(NW, 1, 1)
        c_lane = (cfg.Qq[0] * q1**2 + cfg.Qq[1] * q2**2
                  + cfg.Qq[2] * q3**2).reshape(1, NE, 1)
        c_act = (cfg.R[0] * u1**2 + cfg.R[1] * u2**2 + cfg.R[2] * u3**2)
        c_act = jnp.broadcast_to(c_act, (1,) * 3 + (nu,) * 3).reshape(1, 1, A)
        return ((fw(w1n), fw(w2n), fw(w3n)), (q1, q2, q3, q4),
                (c_row, c_lane, c_act))

    (w_next, q_lane, cost_flat) = jax.jit(small_parts)()
    # host per-row omega values (row digit decode; exact f32 grid values)
    sw = np.asarray(s_w, np.float32)
    wr = (np.repeat(sw, nmw * nmw),
          np.tile(np.repeat(sw, nmw), nmw),
          np.tile(sw, nmw * nmw))

    if block_rows is None:
        # a multiple of nmw^2 rows targeting ~0.5 GB of transients
        per_row = NE * 4 * 12
        g = max(1, min(nmw, int(500e6 / (nmw**2 * per_row)) or 1))
        block_rows = g * nmw**2
    B = min(block_rows, NW)

    gy = jnp.asarray(s_yaw)
    gp = jnp.asarray(s_pitch)
    gr = jnp.asarray(s_roll)

    @_partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4, 5))
    def fill(lo_y, fr_y, lo_p, fr_p, lo_r, fr_r, r0, w1c, w2c, w3c):
        w1 = w1c[:, None]
        w2 = w2c[:, None]
        w3 = w3c[:, None]
        q = tuple(qq[None, :] for qq in q_lane)
        yaw_n, pitch_n, roll_n = _quat_step_readback(cfg, q, w1, w2, w3)
        out = []
        for tgt_lo, tgt_fr, axis, qn in ((lo_y, fr_y, gy, yaw_n),
                                         (lo_p, fr_p, gp, pitch_n),
                                         (lo_r, fr_r, gr, roll_n)):
            lo, fr = axis_locate(axis, qn)
            if edge == "clamp":
                fr = jnp.clip(fr, 0.0, 1.0)
            out.append(jax.lax.dynamic_update_slice(
                tgt_lo, lo.astype(jnp.int32)[:, :, None], (r0, 0, 0)))
            out.append(jax.lax.dynamic_update_slice(
                tgt_fr, fr[:, :, None], (r0, 0, 0)))
        return tuple(out)

    # allocated in the FINAL plan shape — no expand-dims copy at the end
    bufs = []
    for _ in range(3):
        bufs.append(jnp.zeros((NW, NE, 1), jnp.int32))
        bufs.append(jnp.zeros((NW, NE, 1), jnp.float32))
    r0s = list(range(0, NW - B + 1, B))
    if r0s[-1] + B < NW:
        r0s.append(NW - B)               # overlapping idempotent tail block
    for r0 in r0s:
        sl = slice(r0, r0 + B)
        bufs = list(fill(*bufs, jnp.asarray(r0, jnp.int32),
                         jnp.asarray(wr[0][sl]), jnp.asarray(wr[1][sl]),
                         jnp.asarray(wr[2][sl])))

    from ..ops.interp import InterpPlan

    lo_w, fr_w = [], []
    for k in range(3):
        l, f = jax.jit(lambda q, g=grid.axes[k]: axis_locate(g, q))(w_next[k])
        if edge == "clamp":
            f = jnp.clip(f, 0.0, 1.0)
        lo_w.append(l)
        fr_w.append(f)
    plan = InterpPlan(
        lo=tuple(lo_w) + tuple(bufs[0::2]),
        frac=tuple(fr_w) + tuple(bufs[1::2]),
        grid_shape=tuple(grid.shape),
    )
    return plan, cost_flat


def solve_full(
    cfg: AttitudeConfig,
    *,
    num_sweeps: Optional[int] = None,
    impl: str = "auto",
    action_chunk: int = 9,
    state_blocks: int = 1,
    weight_mode: str = "precomputed",
    edge: str = "extrapolate",
    flat: Optional[bool] = None,
    carry_padded: Optional[bool] = None,
    verbose: bool = False,
    segment_size: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    start_sweep: int = 0,
    init_values=None,
    tol: Optional[float] = None,
    tol_mode: str = "abs",
    interpret: bool = False,
) -> FullSolution:
    """``impl='auto'`` = the row/lane kernel on a GPU, the XLA stencil on
    the CPU; ``'rowlane'``/``'stencil'``/``'gather'`` force a path.
    ``action_chunk`` and ``state_blocks`` bound the live intermediates of
    the stencil's fused tap tree (unblocked, the 11^3 x 10^3 stencil's
    temporaries are ~170 MB on an H100 — PERF.md).
    ``flat``/``carry_padded``: force (or forbid) the flat (rows, lanes)
    plan layout and the padded-carry engine mode (whose results STAY in the
    flat layout) — both default to auto-on past 8M cells; tests force them
    small to exercise the big-grid result layout (incl. ``rollout_full``'s
    flat policy lookup) in the fast lane. ``interpret`` runs the row/lane
    kernel in the Pallas interpreter (CPU tests).

    ``segment_size``: run through :func:`engine.value_iteration_segmented`
    instead of one jitted scan — the multi-hour big-grid form:
    ``checkpoint_path`` persists the flat table + sweep index per segment
    (resume via ``init_values``/``start_sweep`` from ``io.load_values``),
    and ``tol``/``tol_mode`` apply the converged engine's stop rule at
    segment boundaries (the reference's check cadence at
    ``segment_size=50``; bitwise the in-loop decision). Results are
    bitwise the unsegmented solve (tests/test_segmented.py)."""
    grid, plan, cost = build_full(cfg, edge=edge, flat=flat)
    sweeps = (cfg.n_stage - 1) if num_sweeps is None else num_sweeps
    if impl == "auto":
        impl = default_impl("rowlane")
    if plan_is_flat(plan) and impl != "rowlane":
        raise ValueError(
            f"grids past 8M cells build flat on-device plans, which only "
            f"the row/lane kernel consumes — use impl='rowlane' "
            f"(got {impl!r})")
    backup = None
    if impl == "stencil":
        backup = build_stencil_backup(plan, cost, action_chunk=action_chunk,
                                      state_blocks=state_blocks,
                                      weight_mode=weight_mode)
    elif impl == "rowlane":
        # the fused row/lane kernel (ops/pallas_backup6.py). Flat plans are
        # dropped right after the build (PlanShape below), so their Euler
        # arrays are .delete()d axis-by-axis as the kernel's padded copies
        # are built — peak device memory = plan + ONE axis, not all six
        from ..engine import policy_dtype_for
        from ..ops.pallas_backup6 import build_pallas_backup_6d

        big = int(np.prod(grid.shape)) > 8_000_000
        # big solves: narrow in-kernel argmin (uint8 at 27 actions) and
        # padded-carry mode — the scan carry IS the kernel's padded table
        # (no per-sweep pad/slice copies) and the result arrays stay FLAT
        # (rows, lanes) across the jit boundary. Use
        # FullSolution.values_6d()/argmin_6d() for host-side 6-D views.
        # Small grids keep int32 (bitwise-stable goldens).
        adt = policy_dtype_for(int(plan.query_shape[-1])) if big \
            else jnp.int32
        backup = build_pallas_backup_6d(
            plan, cost, consume_plan=plan_is_flat(plan), argmin_dtype=adt,
            carry_padded=big if carry_padded is None else carry_padded,
            interpret=interpret)
    elif impl != "gather":
        raise ValueError(f"unknown impl {impl!r}")

    flat_solve = plan_is_flat(plan)
    if flat_solve:
        # the engine only reads shapes once a backup exists; dropping the
        # real plan frees its multi-GB arrays before the solve (the kernel
        # holds its own derived arrays)
        from ..ops.interp import PlanShape

        plan, cost = PlanShape.of(plan), None
    from ..profiling import sweep_callback

    if segment_size is not None:
        from ..engine import value_iteration_segmented
        from ..profiling import SweepTimer

        on_segment = (SweepTimer(verbose=True).on_segment if verbose
                      else None)
        res = value_iteration_segmented(
            plan, cost, sweeps, segment_size=segment_size, backup=backup,
            checkpoint_path=checkpoint_path,
            checkpoint_axes=grid.axes,   # true 1-D axes either layout
            init_values=init_values, start_sweep=start_sweep,
            narrow_argmin_result=flat_solve,
            tol=tol, tol_mode=tol_mode, on_segment=on_segment)
        return FullSolution(cfg, grid, res)
    on_sweep = sweep_callback(verbose)
    return FullSolution(cfg, grid,
                        _jit_solve(plan, cost, backup, sweeps, on_sweep))


# ----------------------------------------------------------------- dynamics

def attitude_rates_kirk(X, U, inertia, inertia_inv=None):
    """7-state derivative [w(3), kirk-q(4)] (spacecraft_dynamics_list
    :600-622 for diagonal inertia; the ode45 variant :849-872 uses the full
    inertia matrix — pass ``inertia`` as (3,3) for that)."""
    w = X[0:3]
    q1, q2, q3, q4 = X[3], X[4], X[5], X[6]
    if inertia_inv is None:
        inertia_inv = jnp.linalg.inv(inertia)
    # float32 matvecs at full precision (a GPU may otherwise use TF32)
    w_dot = jnp.dot(inertia_inv,
                    U - jnp.cross(w, jnp.dot(inertia, w, precision=_HI)),
                    precision=_HI)
    w1, w2, w3 = w[0], w[1], w[2]
    q_dot = 0.5 * jnp.stack([
        w3 * q2 - w2 * q3 + w1 * q4,
        -w3 * q1 + w1 * q3 + w2 * q4,
        w2 * q1 - w1 * q2 + w3 * q4,
        -w1 * q1 - w2 * q2 - w3 * q3,
    ])
    return jnp.concatenate([w_dot, q_dot])


def _renorm_q(X):
    n = jnp.linalg.norm(X[3:7])
    return X.at[3:7].set(X[3:7] / n)


def euler_from_kirk_quat(q_kirk):
    """(yaw, pitch, roll) from kirk-ordered quaternion — the reference's
    ``quat2angle([X7 X6 X5 X4])`` call pattern (:757)."""
    q = jnp.stack([q_kirk[2], q_kirk[1], q_kirk[0], q_kirk[3]])  # -> [x,y,z,w]
    return quat_to_euler_zyx(q)


# ----------------------------------------------------------------- rollouts

def rollout_full(
    sol: FullSolution,
    x0: Optional[jnp.ndarray] = None,
    *,
    method: str = "nearest",
    num_stages: Optional[int] = None,
    device: str = "auto",
):
    """Full-policy rollout with taylor (Euler) steps (:744-833).

    Envelope-scale (flat-layout) solutions fly WITHOUT materializing 6-D
    torque tables: the per-step policy query is an affine nearest locate on
    the 6 axes + a row/lane digit compose + ONE scalar gather from the flat
    argmin (then the 3-digit torque decode) — so billion-cell policies
    solved in the flat (rows, lanes) layout roll out on device as-is.
    Flat solutions support ``method='nearest'`` only (the reference's
    policy-rollout interpolant); small solves also offer 'interp'.

    ``device='auto'`` runs the sequential single-flight scan on the host
    CPU backend (the pos_att routing: one flight is a chain of tiny
    dependent steps) — EXCEPT when the policy source is big (> 64 MB, i.e.
    a big-grid flat argmin), which stays on its device rather than being
    copied to the host.

    Returns (X, U, ANGLES): states (N, 7), torques (N-1, 3), Euler angles
    (N-1, 3).
    """
    from .pos_att import _rollout_device

    cfg = sol.config
    n = (num_stages or cfg.n_stage)
    axes = sol.grid.axes
    dev = _rollout_device(device)
    if sol.is_flat:
        a = sol.result.argmin
        if a.size * a.dtype.itemsize > 64 * 1024 * 1024:
            dev = jax.devices()[0]      # big policy: fly where it lives
    with jax.default_device(dev):
        inertia_d = jnp.asarray(np.diag(cfg.inertia_diag), jnp.float32)
        inertia_d_inv = jnp.asarray(
            np.diag(1.0 / np.asarray(cfg.inertia_diag)), jnp.float32)
        if sol.is_flat:
            if method != "nearest":
                raise ValueError(
                    "flat-layout solutions support method='nearest' only "
                    "(6-D interpolated torque tables would have to be "
                    "materialized)")
            from ..ops.interp import affine_axes, nearest_cell_index

            aff = affine_axes(axes)
            shape = sol.grid.shape
            argmin_flat = jax.device_put(sol.result.argmin, dev)
            u_vec = jnp.asarray(cfg.u_vector)
            row_mul = jnp.asarray(
                [shape[1] * shape[2], shape[2], 1, 0, 0, 0], jnp.int32)
            lane_mul = jnp.asarray(
                [0, 0, 0, shape[4] * shape[5], shape[5], 1], jnp.int32)

            def lookup(pt):
                idx = nearest_cell_index(aff, jnp.stack(pt))
                a = argmin_flat[jnp.sum(idx * row_mul),
                                jnp.sum(idx * lane_mul)].astype(jnp.int32)
                return jnp.stack(decode_torque_digits(a, u_vec))
        else:
            tables = jax.device_put(np.asarray(sol.u_tables), dev)
            eval_fn = nearest_eval if method == "nearest" else (
                lambda t, a, p: interp_eval(t, a, p))

            def lookup(pt):
                return jnp.stack([eval_fn(tables[i], axes, pt)
                                  for i in range(3)])

        def step(X, _):
            yaw, pitch, roll = euler_from_kirk_quat(X[3:7])
            U = lookup((X[0], X[1], X[2], yaw, pitch, roll))
            X_dot = attitude_rates_kirk(X, U, inertia_d, inertia_d_inv)
            X_next = _renorm_q(X + cfg.h * X_dot)
            return X_next, (X, U, jnp.stack([yaw, pitch, roll]))

        X0 = AttitudeConfig.default_x0() if x0 is None else jnp.asarray(x0)
        X_fin, (X, U, ang) = jax.lax.scan(step, X0, None, length=n - 1)
        X = jnp.concatenate([X, X_fin[None]], axis=0)
    return X, U, ang


def rollout_simplified_plant(
    sol: SimplifiedSolution,
    x0=None,
    *,
    num_stages: Optional[int] = None,
):
    """Policy-on-SIMPLIFIED-plant rollout: 3 decoupled (omega_i, theta_i)
    double integrators stepped with the training dynamics — the first half
    of the reference's train-on-simplified/validate-on-real check
    (attitude-control/test/test_simplified.m:121-264).

    ``x0``: (3, 2) array of per-axis (omega, theta) initial states (defaults
    to the angles of the standard X0 with zero rates). Returns (X, U) with
    X (N, 3, 2) and U (N-1, 3).
    """
    from .pos_att import _rollout_device

    cfg = sol.config
    n = (num_stages or cfg.n_stage)
    c_h = _quirk(cfg.h, cfg.rk4_t_parity)
    with jax.default_device(_rollout_device("auto")):  # single flight ->
        if x0 is None:                                 # host (pos_att doc)
            q = AttitudeConfig.default_x0()[3:7]
            theta = 2.0 * jnp.arcsin(jnp.clip(q[:3], -1.0, 1.0))
            x0 = jnp.stack([jnp.zeros(3), theta], axis=1)
        tables = [jnp.asarray(np.asarray(t)) for t in sol.u_tables]
        axes = sol.axes
        J = jnp.asarray(cfg.inertia_diag)

        def step(X, _):
            U = jnp.stack([
                nearest_eval(tables[i], axes[i], (X[i, 0], X[i, 1]))
                for i in range(3)
            ])
            w_next = X[:, 0] + cfg.h * U / J
            t_next = X[:, 1] + cfg.h * X[:, 0] * c_h
            X_next = jnp.stack([w_next, t_next], axis=1)
            return X_next, (X, U)

        X0 = jnp.asarray(x0, jnp.float32)
        X_fin, (X, U) = jax.lax.scan(step, X0, None, length=n - 1)
        X = jnp.concatenate([X, X_fin[None]], axis=0)
    return X, U


def rollout_simplified_real_dynamics(
    sol: SimplifiedSolution,
    x0: Optional[jnp.ndarray] = None,
    *,
    num_stages: Optional[int] = None,
    ode_tol: Optional[float] = None,
    integrator: str = "ode45",
):
    """Train-on-simplified / validate-on-real (:835-925): per-axis policies
    looked up at (omega_i, 2*asin(kirk q_i)), plant = full nonlinear rigid
    body with the complete inertia matrix, integrated per stage with
    ``integrator``: 'ode45' (default; the reference uses MATLAB ode45 here,
    Solver_attitude.m:851,885), 'rkf45' (Fehlberg), or 'rk4' (one fixed
    step per stage — the fast serving mode). ``ode_tol=None``
    keeps each pair's reference defaults; an explicit value sets rkf45's
    tol, or ode45's RelTol with AbsTol at MATLAB's 1e-3 ratio."""
    from ..utils.integrators import integrator_kwargs
    from .pos_att import _rollout_device

    cfg = sol.config
    n = (num_stages or cfg.n_stage)
    _adaptive, _kw = integrator_kwargs(integrator, ode_tol)
    with jax.default_device(_rollout_device("auto")):  # single flight ->
        inertia = jnp.asarray(cfg.inertia_matrix, jnp.float32)  # host
        inertia_inv = jnp.asarray(np.linalg.inv(cfg.inertia_matrix),
                                  jnp.float32)
        tables = [jnp.asarray(np.asarray(t)) for t in sol.u_tables]
        axes = sol.axes

        def step(carry, k):
            X = carry
            theta = 2.0 * jnp.arcsin(jnp.clip(X[3:6], -1.0, 1.0))
            U = jnp.stack([
                nearest_eval(tables[i], axes[i], (X[i], theta[i]))
                for i in range(3)
            ])
            f = lambda t, y: attitude_rates_kirk(y, U, inertia,  # noqa: E731
                                                 inertia_inv)
            t0 = k * cfg.h
            X_next = _renorm_q(_adaptive(f, t0, t0 + cfg.h, X, **_kw))
            return X_next, (X, U)

        X0 = AttitudeConfig.default_x0() if x0 is None else jnp.asarray(x0)
        X_fin, (X, U) = jax.lax.scan(step, X0, jnp.arange(n - 1))
        X = jnp.concatenate([X, X_fin[None]], axis=0)
    return X, U


def linear_control_response(
    cfg: AttitudeConfig = AttitudeConfig(),
    x0: Optional[jnp.ndarray] = None,
    *,
    T_final: Optional[float] = None,
    dt: Optional[float] = None,
    K: float = 0.2,
    C: float = 1.0,
):
    """Quaternion PD baseline (:508-591): U = -K*q_vec - C*w, RK4 steps of
    the diagonal... full 7-state dynamics with q renormalization.

    Returns (X, U, qnorm_drift) — the drift sqrt(|q|-1 at T_final) is the
    reference's integration-error metric (:543-548).
    """
    h = dt or cfg.h
    n = int(np.ceil((T_final or cfg.T_final) / h))
    inertia_d = jnp.asarray(np.diag(cfg.inertia_diag), jnp.float32)
    inertia_d_inv = jnp.asarray(np.diag(1.0 / np.asarray(cfg.inertia_diag)),
                                jnp.float32)

    def step(X, _):
        U = -K * X[3:6] - C * X[0:3]
        f = lambda t, y: attitude_rates_kirk(y, U, inertia_d, inertia_d_inv)  # noqa: E731
        X_next = _renorm_q(rk4_step(f, 0.0, X, h))
        return X_next, (X, U)

    X0 = AttitudeConfig.default_x0() if x0 is None else jnp.asarray(x0)
    X_fin, (X, U) = jax.lax.scan(step, X0, None, length=n)
    X = jnp.concatenate([X, X_fin[None]], axis=0)
    drift = jnp.abs(jnp.linalg.norm(X_fin[3:7]) - 1.0)
    return X, U, drift
