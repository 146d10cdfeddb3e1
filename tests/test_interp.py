"""Interpolation-kernel unit tests vs the independent numpy oracle.

The JAX-build equivalent of the reference's semantics-exploration tests
(test/test_griddedInterp.m): correctness on known surfaces, extrapolation
behavior, rectilinear (sym_linspace) axes."""

import numpy as np
import pytest

import jax.numpy as jnp

from ocdp_tpu import Grid, build_plan, interp_apply, interp_eval, sym_linspace_exact
from oracle import interp_many


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_matches_oracle_random(d):
    rng = np.random.default_rng(d)
    axes = []
    for k in range(d):
        n = rng.integers(3, 9)
        ax = np.sort(rng.uniform(-2, 2, size=n)).astype(np.float32)
        while np.any(np.diff(ax) < 1e-3):
            ax = np.sort(rng.uniform(-2, 2, size=n)).astype(np.float32)
        axes.append(ax)
    values = rng.standard_normal([len(a) for a in axes]).astype(np.float32)
    # queries: interior, on-grid, and out-of-bounds (extrapolation)
    pts = np.stack(
        [rng.uniform(axes[k][0] - 1.0, axes[k][-1] + 1.0, size=64) for k in range(d)],
        axis=-1,
    ).astype(np.float32)
    # include exact grid points
    for j in range(min(8, pts.shape[0])):
        for k in range(d):
            pts[j, k] = axes[k][rng.integers(len(axes[k]))]

    got = interp_eval(values, axes, tuple(pts[:, k] for k in range(d)))
    want = interp_many(values, axes, pts)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


def test_linear_function_exact_everywhere():
    # A multilinear interpolant of a linear function reproduces it exactly,
    # including in the extrapolation region — the acid test for MATLAB-style
    # linear extrapolation (the reference never clamps; SURVEY.md §7).
    ax = np.linspace(-1, 1, 11).astype(np.float32)
    g = Grid((ax, ax))
    x1, x2 = g.meshgrid()
    values = 3.0 * x1 - 2.0 * x2 + 0.5
    q1 = np.array([-5.0, -1.0, 0.0, 2.5, 7.0], np.float32)
    q2 = np.array([4.0, -3.0, 0.1, -9.0, 1.0], np.float32)
    got = interp_eval(values, g.axes, (q1, q2))
    np.testing.assert_allclose(np.asarray(got), 3 * q1 - 2 * q2 + 0.5, rtol=1e-5, atol=1e-5)


def test_rectilinear_sym_axis():
    # pos-att sym_linspace axes have unequal spacing around zero
    # (Solver_pos_att.m:906-918) — interpolation must honor per-cell widths.
    ax = sym_linspace_exact(-0.1, 0.1, 30)
    assert len(ax) == 30
    assert 0.0 in ax.tolist()
    d = np.diff(ax.astype(np.float64))
    assert not np.allclose(d.min(), d.max())
    values = np.sin(7 * ax).astype(np.float32)
    q = np.linspace(-0.12, 0.12, 101).astype(np.float32)
    got = interp_eval(values, (ax,), (q,))
    want = interp_many(values, (ax,), q[:, None])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_broadcast_plan_shapes():
    # separable queries: axis-0 coordinate varies only along dims (0, 2);
    # axis-1 coordinate varies only along dims (1, 2)
    ax = np.linspace(0, 1, 6).astype(np.float32)
    rng = np.random.default_rng(0)
    values = rng.standard_normal((6, 6)).astype(np.float32)
    qa = rng.uniform(0, 1, size=(4, 1, 3)).astype(np.float32)
    qb = rng.uniform(0, 1, size=(1, 5, 3)).astype(np.float32)
    plan = build_plan((ax, ax), (qa, qb))
    got = np.asarray(interp_apply(jnp.asarray(values), plan))
    assert got.shape == (4, 5, 3)
    full = np.stack(np.broadcast_arrays(qa * np.ones((4, 5, 3)), qb * np.ones((4, 5, 3))), -1)
    want = interp_many(values, (ax, ax), full.reshape(-1, 2)).reshape(4, 5, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_nearest_midpoint_tie_snaps_low():
    """PINS the 'nearest' exact-midpoint tie rule: snap to the LOWER
    neighbor (VERDICT r3 missing item 1). MATLAB does not document
    griddedInterpolant('nearest')'s midpoint side and none is available to
    measure here — the rule is pinned so any future change is deliberate.
    See the nearest_eval docstring for the full parity note."""
    from ocdp_tpu.ops.interp import nearest_eval

    ax = np.asarray([0.0, 1.0, 2.0, 3.0], np.float32)
    vals = np.asarray([10.0, 20.0, 30.0, 40.0], np.float32)
    # exact midpoints (representable in f32) -> lower neighbor
    got = np.asarray(nearest_eval(vals, [ax], (jnp.asarray(
        [0.5, 1.5, 2.5], jnp.float32),)))
    np.testing.assert_array_equal(got, [10.0, 20.0, 30.0])
    # epsilon above a midpoint -> upper neighbor
    got = np.asarray(nearest_eval(vals, [ax], (jnp.asarray(
        [0.5 + 1e-6, 1.5 + 1e-6], jnp.float32),)))
    np.testing.assert_array_equal(got, [20.0, 30.0])
    # outside the grid -> nearest edge point (MATLAB 'nearest' extrapolation)
    got = np.asarray(nearest_eval(vals, [ax], (jnp.asarray(
        [-5.0, 9.0], jnp.float32),)))
    np.testing.assert_array_equal(got, [10.0, 40.0])


def test_affine_axes_nearest_matches_searchsorted():
    """The serving-path arithmetic locate (ops/interp.affine_axes /
    nearest_cell_index) must reproduce nearest_eval's searchsorted index
    math — same edge clamp, same lower-snap midpoint rule — on uniform,
    two-piece sym_linspace (even n: differing half spacings), and
    out-of-grid queries."""
    import jax.numpy as jnp

    from ocdp_tpu.grids import linspace_axis, sym_linspace_exact, \
        sym_linspace_inclusive
    from ocdp_tpu.ops.interp import affine_axes, nearest_cell_index

    rng = np.random.default_rng(7)
    axes = (sym_linspace_exact(-0.2, 0.2, 30),     # even n: rectilinear
            sym_linspace_exact(-0.1, 0.1, 15),     # odd n: uniform halves
            sym_linspace_inclusive(-1.0, 1.0, 200),
            linspace_axis(-3.0, 5.0, 17))
    aff = affine_axes(axes)
    q = np.stack([rng.uniform(a[0] * 1.5, a[-1] * 1.5, 5000)
                  .astype(np.float32) for a in axes], axis=-1)
    got = np.asarray(nearest_cell_index(aff, jnp.asarray(q)))
    for k, ax in enumerate(axes):
        g = jnp.asarray(ax)
        qq = jnp.asarray(q[:, k])
        lo = jnp.clip(jnp.searchsorted(g, qq, side="right") - 1, 0,
                      g.shape[0] - 2)
        hi = (qq - jnp.take(g, lo)) > (jnp.take(g, lo + 1) - qq)
        ref = np.asarray(jnp.where(hi, lo + 1, lo))
        np.testing.assert_array_equal(got[:, k], ref)
    # exact grid points snap to themselves
    gq = np.stack([a[:5] for a in axes], axis=-1)
    np.testing.assert_array_equal(
        np.asarray(nearest_cell_index(aff, jnp.asarray(gq))),
        np.broadcast_to(np.arange(5)[:, None], (5, 4)))


def test_affine_axes_rejects_non_piecewise():
    from ocdp_tpu.ops.interp import affine_axes

    with pytest.raises(ValueError, match="piecewise-uniform"):
        affine_axes((np.array([0.0, 1.0, 3.0, 7.0], np.float32),))
