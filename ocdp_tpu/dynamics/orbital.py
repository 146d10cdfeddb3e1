"""Universal-variable Keplerian propagation (Curtis algorithms, JAX-native).

JAX re-design of the reference's ``private/`` orbital library
(position-control/private/{stumpC,stumpS,kepler_U,f_and_g,fDot_and_gDot,
sv_from_coe}.m, byte-identical copy under pos-att/private/): same algorithms
from Curtis, *Orbital Mechanics for Engineering Students* (eqs. 3.52-3.53,
3.66-3.69, alg. 3.4/4.5), written as branchless, jittable pure functions —
``jnp.where`` instead of sign branches, ``lax.while_loop`` for the Newton
iteration — so the whole closed-loop rollout stays on device.

Improvements over the reference kept behavior-compatible:
* Stumpff functions use a series expansion near z=0 (the reference only
  special-cases z==0 exactly), which matters in f32.
* ``mu`` is an argument (the reference uses a ``global mu``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "MU_EARTH",
    "stumpff_C",
    "stumpff_S",
    "kepler_universal",
    "lagrange_f_g",
    "lagrange_fdot_gdot",
    "propagate_kepler",
    "sv_from_coe",
    "target_orbit_R0V0",
]

MU_EARTH = 398600.0  # km^3/s^2 (position-control/Solver_position.m:192)
_R_EARTH = 6378.0    # km (Solver_position.m:315)


def stumpff_C(z):
    """Stumpff C(z) (Curtis eq. 3.53; stumpC.m:11-17), branchless."""
    z = jnp.asarray(z)
    small = jnp.abs(z) < 1e-4
    zs = jnp.where(small, 1.0, z)  # safe operand
    sz = jnp.sqrt(jnp.abs(zs))
    pos = (1.0 - jnp.cos(sz)) / jnp.abs(zs)
    neg = (jnp.cosh(sz) - 1.0) / jnp.abs(zs)
    series = 0.5 - z / 24.0 + z * z / 720.0
    return jnp.where(small, series, jnp.where(z > 0, pos, neg))


def stumpff_S(z):
    """Stumpff S(z) (Curtis eq. 3.52; stumpS.m:11-17), branchless."""
    z = jnp.asarray(z)
    small = jnp.abs(z) < 1e-4
    zs = jnp.where(small, 1.0, z)
    sz = jnp.sqrt(jnp.abs(zs))
    pos = (sz - jnp.sin(sz)) / sz**3
    neg = (jnp.sinh(sz) - sz) / sz**3
    series = 1.0 / 6.0 - z / 120.0 + z * z / 5040.0
    return jnp.where(small, series, jnp.where(z > 0, pos, neg))


def kepler_universal(dt, r0, vr0, alpha, *, mu=MU_EARTH, tol=1e-8, max_iter=1000):
    """Newton solve of the universal Kepler equation for the anomaly x.

    Same iteration as kepler_U.m:20-36: x0 = sqrt(mu)*|alpha|*dt, ratio
    F/F' until |ratio| < tol.
    """
    dt = jnp.asarray(dt)
    smu = jnp.sqrt(mu)
    x0 = smu * jnp.abs(alpha) * dt

    def body(carry):
        x, _, n = carry
        z = alpha * x * x
        C = stumpff_C(z)
        S = stumpff_S(z)
        F = r0 * vr0 / smu * x * x * C + (1 - alpha * r0) * x**3 * S + r0 * x - smu * dt
        dFdx = r0 * vr0 / smu * x * (1 - z * S) + (1 - alpha * r0) * x * x * C + r0
        ratio = F / dFdx
        return x - ratio, ratio, n + 1

    def cond(carry):
        _, ratio, n = carry
        return jnp.logical_and(jnp.abs(ratio) > tol, n <= max_iter)

    x, _, _ = jax.lax.while_loop(cond, body, (x0, jnp.ones_like(x0), 0))
    return x


def lagrange_f_g(x, t, r0, alpha, *, mu=MU_EARTH):
    """Lagrange f, g (Curtis eq. 3.69a/b; f_and_g.m:13-16)."""
    z = alpha * x * x
    f = 1.0 - x * x / r0 * stumpff_C(z)
    g = t - x**3 * stumpff_S(z) / jnp.sqrt(mu)
    return f, g


def lagrange_fdot_gdot(x, r, r0, alpha, *, mu=MU_EARTH):
    """Lagrange fdot, gdot (Curtis eq. 3.69c/d; fDot_and_gDot.m:14-17)."""
    z = alpha * x * x
    fdot = jnp.sqrt(mu) / (r * r0) * (z * stumpff_S(z) - 1.0) * x
    gdot = 1.0 - x * x / r * stumpff_C(z)
    return fdot, gdot


def propagate_kepler(R0, V0, t, *, mu=MU_EARTH):
    """Propagate a two-body state vector by ``t`` seconds (Curtis alg. 3.4).

    The reference's ``update_RV_target`` (Solver_position.m:333-361;
    Solver_pos_att.m:754-782). Returns (R, V).
    """
    R0 = jnp.asarray(R0)
    V0 = jnp.asarray(V0)
    r0 = jnp.linalg.norm(R0)
    v0 = jnp.linalg.norm(V0)
    vr0 = jnp.dot(R0, V0) / r0
    alpha = 2.0 / r0 - v0 * v0 / mu
    x = kepler_universal(t, r0, vr0, alpha, mu=mu)
    f, g = lagrange_f_g(x, t, r0, alpha, mu=mu)
    R = f * R0 + g * V0
    r = jnp.linalg.norm(R)
    fdot, gdot = lagrange_fdot_gdot(x, r, r0, alpha, mu=mu)
    V = fdot * R0 + gdot * V0
    return R, V


def sv_from_coe(h, e, RA, incl, w, TA, *, mu=MU_EARTH):
    """State vector from classical orbital elements (Curtis alg. 4.5).

    Elements ordered as sv_from_coe.m:25-31: angular momentum h, eccentricity
    e, right ascension RA, inclination incl, argument of perigee w, true
    anomaly TA (radians). Returns (r, v) in the geocentric equatorial frame.
    """
    cT, sT = jnp.cos(TA), jnp.sin(TA)
    rp = (h * h / mu) / (1.0 + e * cT) * jnp.stack([cT, sT, jnp.zeros_like(cT)])
    vp = (mu / h) * jnp.stack([-sT, e + cT, jnp.zeros_like(cT)])

    cR, sR = jnp.cos(RA), jnp.sin(RA)
    ci, si = jnp.cos(incl), jnp.sin(incl)
    cw, sw = jnp.cos(w), jnp.sin(w)
    R3_W = jnp.array([[cR, sR, 0.0], [-sR, cR, 0.0], [0.0, 0.0, 1.0]])
    R1_i = jnp.array([[1.0, 0.0, 0.0], [0.0, ci, si], [0.0, -si, ci]])
    R3_w = jnp.array([[cw, sw, 0.0], [-sw, cw, 0.0], [0.0, 0.0, 1.0]])
    Q_pX = (R3_w @ R1_i @ R3_W).T
    return Q_pX @ rp, Q_pX @ vp


def target_orbit_R0V0(*, perigee_alt=300.0, e=0.1, mu=MU_EARTH):
    """The reference target orbit: 300-km-perigee, e=0.1, equatorial.

    get_target_R0V0 (Solver_position.m:313-331; Solver_pos_att.m:734-752).

    Runs PINNED to the host CPU backend and memoized: these are a dozen
    eager scalar ops, each a separate dispatch (and compile) on an
    accelerator, for one constant result.
    """
    key = (perigee_alt, e, mu)
    hit = _R0V0_CACHE.get(key)
    if hit is not None:
        return hit
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        rp = _R_EARTH + perigee_alt
        ra = rp * (1 + e) / (1 - e)
        h = jnp.sqrt(2 * mu * rp * ra / (ra + rp))
        zero = jnp.asarray(0.0)
        R0, V0 = sv_from_coe(h, e, zero, zero, zero, zero, mu=mu)
        R0, V0 = np.asarray(R0), np.asarray(V0)
    _R0V0_CACHE[key] = (R0, V0)
    return R0, V0


_R0V0_CACHE: dict = {}
