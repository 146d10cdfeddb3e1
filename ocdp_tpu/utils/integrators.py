"""On-device ODE integrators (SURVEY.md L2/L6).

The reference integrates rollout plants with MATLAB ``ode45`` or the Curtis
``rkf45`` adaptive Runge-Kutta-Fehlberg routine
(position-control/private/rkf45.m; pos-att/Solver_pos_att.m:504). Both are
re-designed here as jit/scan-compatible pure functions: fixed-step RK4 for
grid dynamics and a ``lax.while_loop`` RKF4(5) with the same embedded
coefficients and step-control law for rollouts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["rk4_step", "rkf45_integrate", "ode45_integrate"]


def rk4_step(f, t, y, h):
    """One classical RK4 step of ``dy/dt = f(t, y)``."""
    k1 = f(t, y)
    k2 = f(t + h / 2, y + (h / 2) * k1)
    k3 = f(t + h / 2, y + (h / 2) * k2)
    k4 = f(t + h, y + h * k3)
    return y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)


# Fehlberg coefficients (Curtis, Orbital Mechanics, Table D.x; identical to
# position-control/private/rkf45.m:27-47)
_A = np.array([0, 1 / 4, 3 / 8, 12 / 13, 1, 1 / 2])
_B = np.array([
    [0, 0, 0, 0, 0],
    [1 / 4, 0, 0, 0, 0],
    [3 / 32, 9 / 32, 0, 0, 0],
    [1932 / 2197, -7200 / 2197, 7296 / 2197, 0, 0],
    [439 / 216, -8, 3680 / 513, -845 / 4104, 0],
    [-8 / 27, 2, -3544 / 2565, 1859 / 4104, -11 / 40],
])
_C4 = np.array([25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0])
_C5 = np.array([16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55])


def rkf45_integrate(f, t0, t1, y0, *, tol=1e-8, max_steps=10_000):
    """Adaptive RKF4(5) from ``t0`` to ``t1``; returns ``y(t1)``.

    Step-control law matches the reference (rkf45.m:73-113): initial step
    ``(t1-t0)/100``; truncation error per step ``te = h*(C4-C5)·k`` compared
    against ``tol*max(|y|, 1)``; accepted steps advance with the 5th-order
    combination ``y + h*C5·k``; step scaled by
    ``h_new = h*min((te_allowed/te_max)^(1/5), 4)`` with no extra safety
    factor. Runs entirely on device as a ``lax.while_loop``.
    """
    dtype = jnp.result_type(y0)
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    y0 = jnp.asarray(y0, dtype)
    h0 = (t1 - t0) / 100.0  # reference: "Assumed initial time step" rkf45.m:73

    def body(carry):
        t, y, h, steps = carry
        h = jnp.minimum(h, t1 - t)

        ks = []
        for i in range(6):
            yi = y
            for j in range(i):
                if _B[i, j] != 0.0:
                    yi = yi + h * _B[i, j] * ks[j]
            ks.append(f(t + _A[i] * h, yi))
        k = jnp.stack(ks)
        te = h * jnp.tensordot(jnp.asarray(_C4 - _C5, dtype), k, axes=1)
        y5 = y + h * jnp.tensordot(jnp.asarray(_C5, dtype), k, axes=1)

        ymax = jnp.maximum(jnp.max(jnp.abs(y)), 1.0)
        te_allowed = tol * ymax
        te_max = jnp.max(jnp.abs(te))
        delta = (te_allowed / (te_max + 1e-30)) ** 0.2

        accept = te_max <= te_allowed
        t_new = jnp.where(accept, t + h, t)
        y_new = jax.tree.map(lambda a, b: jnp.where(accept, a, b), y5, y)
        h_new = h * jnp.minimum(delta, 4.0)
        return t_new, y_new, h_new, steps + 1

    def cond(carry):
        t, _, _, steps = carry
        return jnp.logical_and(t < t1, steps < max_steps)

    t_fin, y_fin, _, _ = jax.lax.while_loop(cond, body,
                                            (t0, y0, h0, jnp.asarray(0)))
    # MATLAB's integrators error/warn when tolerances can't be met within
    # the step budget; silently returning y(t < t1) would be a wrong
    # trajectory with no signal. Poison truncated integrations with NaN so
    # they are detectable downstream (rollout states turn visibly NaN).
    return jnp.where(t_fin < t1, jnp.nan, 1.0).astype(dtype) * y_fin


# Dormand-Prince 5(4) tableau — the pair inside MATLAB ode45, which the
# reference uses for the attitude and pos-att closed-loop plants
# (pos-att/Solver_pos_att.m:504; attitude-control/Solver_attitude.m:851).
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
])
# 5th-order solution weights (row 7 of A: FSAL — k7 = f(t+h, y5)).
_DP_B5 = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                   11 / 84, 0])
# Error weights b5 - b4 (MATLAB ode45's E vector).
_DP_E = np.array([71 / 57600, 0, -71 / 16695, 71 / 1920, -17253 / 339200,
                  22 / 525, -1 / 40])


def ode45_integrate(f, t0, t1, y0, *, rtol=1e-3, atol=1e-6,
                    max_steps=10_000):
    """Adaptive Dormand-Prince 5(4) from ``t0`` to ``t1``; returns ``y(t1)``.

    Tableau and step control replicate MATLAB ``ode45`` defaults
    (RelTol=1e-3, AbsTol=1e-6), which the reference relies on for the
    13-state pos-att closed loop (Solver_pos_att.m:504) and the attitude
    validate-on-real rollouts (Solver_attitude.m:851,885):

    * mixed error norm ``err = h * max|E.k / max(max(|y|,|y5|), thr)|`` with
      ``thr = atol/rtol``; accept when ``err <= rtol``;
    * initial step ``min(hmax, t1-t0)`` shrunk by the start-slope heuristic
      ``1/rh`` with ``rh = max|f0/max(|y0|,thr)| / (0.8 rtol^{1/5})``,
      ``hmax = 0.1 (t1-t0)``;
    * accepted steps grow by at most 5x (``h /= max(1.25 (err/rtol)^{1/5},
      0.2)``); the first rejection shrinks by ``max(0.1, 0.8
      (rtol/err)^{1/5})``, repeat rejections halve;
    * FSAL: the 7th stage of an accepted step is next step's ``k1``.

    Runs on device as a ``lax.while_loop``. See also :func:`rkf45_integrate`
    (the Curtis/Fehlberg pair the reference's position rollout uses).
    """
    dtype = jnp.result_type(y0)
    t0 = jnp.asarray(t0, dtype)
    t1 = jnp.asarray(t1, dtype)
    y0 = jnp.asarray(y0, dtype)
    thr = atol / rtol
    hmax = 0.1 * (t1 - t0)  # MATLAB default MaxStep = 0.1*tspan

    f0 = f(t0, y0)
    rh = jnp.max(jnp.abs(f0) / jnp.maximum(jnp.abs(y0), thr)) / (
        0.8 * rtol ** 0.2)
    h0 = jnp.minimum(hmax, t1 - t0)
    h0 = jnp.where(h0 * rh > 1.0, 1.0 / rh, h0)

    def body(carry):
        t, y, h, k1, rejected, steps = carry
        h = jnp.minimum(h, t1 - t)

        ks = [k1]
        for i in range(1, 7):
            yi = y
            for j in range(i):
                if _DP_A[i, j] != 0.0:
                    yi = yi + h * _DP_A[i, j] * ks[j]
            ks.append(f(t + _DP_C[i] * h, yi))
        k = jnp.stack(ks)
        y5 = y + h * jnp.tensordot(jnp.asarray(_DP_B5, dtype), k, axes=1)
        ek = jnp.tensordot(jnp.asarray(_DP_E, dtype), k, axes=1)
        denom = jnp.maximum(jnp.maximum(jnp.abs(y), jnp.abs(y5)), thr)
        err = h * jnp.max(jnp.abs(ek / denom))

        accept = err <= rtol
        # growth (accepted): h / max(1.25*(err/rtol)^(1/5), 0.2)
        grow = h / jnp.maximum(1.25 * (err / rtol + 1e-30) ** 0.2, 0.2)
        # shrink (rejected): first max(0.1, 0.8*(rtol/err)^(1/5)), then 0.5
        shrink1 = h * jnp.maximum(0.1, 0.8 * (rtol / (err + 1e-30)) ** 0.2)
        shrink = jnp.where(rejected, 0.5 * h, shrink1)

        t_new = jnp.where(accept, t + h, t)
        y_new = jnp.where(accept, y5, y)
        k1_new = jnp.where(accept, ks[6], k1)  # FSAL
        h_new = jnp.minimum(jnp.where(accept, grow, shrink), hmax)
        return t_new, y_new, h_new, k1_new, ~accept, steps + 1

    def cond(carry):
        t, _, _, _, _, steps = carry
        return jnp.logical_and(t < t1, steps < max_steps)

    t_fin, y_fin, _, _, _, _ = jax.lax.while_loop(
        cond, body,
        (t0, y0, h0, f0, jnp.asarray(False), jnp.asarray(0)))
    # see rkf45_integrate: truncated integrations return NaN, not y(t<t1)
    return jnp.where(t_fin < t1, jnp.nan, 1.0).astype(dtype) * y_fin


_ADAPTIVE = {"rkf45": rkf45_integrate, "ode45": ode45_integrate}


def adaptive_integrator(name: str):
    """Resolve an adaptive-integrator name: 'rkf45' (Curtis/Fehlberg,
    private/rkf45.m) or 'ode45' (Dormand-Prince, MATLAB ode45 defaults)."""
    try:
        return _ADAPTIVE[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; choose from {sorted(_ADAPTIVE)}"
        ) from None


def _rk4_span(f, t0, t1, y0):
    """Fixed-step bridge: ONE classical RK4 step across [t0, t1]."""
    return rk4_step(f, t0, y0, t1 - t0)


def integrator_kwargs(name: str, tol=None):
    """Resolve ``(integrator_fn, tolerance_kwargs)`` for the rollouts.

    ``name``: 'ode45' / 'rkf45' (adaptive pairs, reference parity) or
    'rk4' — ONE classical RK4 step per stage interval, no adaptive
    while_loop. The closed loops step at the reference's h = 5 ms, where a
    single 4th-order step is already at f32 accuracy; without the nested
    step-control loops the rollout scan vectorizes cleanly across a fleet
    (the receding-horizon serving path).

    ``tol=None`` keeps each pair's reference defaults (rkf45: the Curtis
    1e-8; ode45: MATLAB RelTol=1e-3 / AbsTol=1e-6). An explicit ``tol``
    sets rkf45's ``tol`` directly, or ode45's RelTol with AbsTol held at
    MATLAB's default 1e-3 ratio — it is never silently ignored ('rk4' has
    no tolerance and rejects one).
    """
    if name == "rk4":
        if tol is not None:
            raise ValueError("'rk4' is fixed-step; ode_tol does not apply")
        return _rk4_span, {}
    fn = adaptive_integrator(name)
    if tol is None:
        return fn, ({"tol": 1e-8} if name == "rkf45" else {})
    if name == "rkf45":
        return fn, {"tol": tol}
    return fn, {"rtol": tol, "atol": 1e-3 * tol}
