"""State-blocked stencil == unblocked stencil == gather backup."""

import numpy as np
import jax.numpy as jnp
import pytest

from ocdp_tpu import bellman_backup
from ocdp_tpu.models import kirk
from ocdp_tpu.ops.stencil import build_stencil_backup


@pytest.mark.parametrize("blocks", [2, 4])
def test_blocked_matches_unblocked(blocks):
    problem = kirk.build(kirk.KirkConfig(N=10, dx=20, du=50))
    v = jnp.asarray(np.random.default_rng(0).normal(size=(20, 20)), jnp.float32)
    ref = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10)(v)
    got = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10, state_blocks=blocks)(v)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin), np.asarray(ref.argmin))


def test_blocked_matches_gather_with_factorized_cost():
    problem = kirk.build(kirk.KirkConfig(N=8, dx=16, du=20))
    cfg = problem.config
    s = problem.grid.axes[0]
    x1 = jnp.asarray(s)[:, None, None]
    x2 = jnp.asarray(s)[None, :, None]
    u = jnp.asarray(problem.u_mesh)[None, None, :]
    terms = (cfg.Q[0] * x1**2, cfg.Q[1] * x2**2, cfg.R * u**2)
    v = jnp.asarray(np.random.default_rng(1).normal(size=(16, 16)), jnp.float32)
    ref = bellman_backup(v, problem.plan, terms)
    got = build_stencil_backup(problem.plan, terms, action_chunk=5,
                               state_blocks=4)(v)
    np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                               rtol=2e-6, atol=2e-6)
    mism = np.asarray(got.argmin) != np.asarray(ref.argmin)
    assert mism.mean() < 0.002


@pytest.mark.parametrize("blocks", [(2, 2), (1, 4), (5, 5), (4, 1)])
def test_multiaxis_blocked_matches_unblocked(blocks):
    """Blocking BOTH state axes: parity + the band must shrink.

    Values are ULP-tolerant, not bitwise: XLA CPU contracts mul+add into
    FMA differently depending on the block shapes it vectorizes over
    (measured <= 4.8e-7 abs on this workload).
    Argmin must agree exactly — the ULP drift never crosses a tie here.
    """
    problem = kirk.build(kirk.KirkConfig(N=10, dx=20, du=50))
    v = jnp.asarray(np.random.default_rng(5).normal(size=(20, 20)), jnp.float32)
    ref = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10)(v)
    sb = build_stencil_backup(problem.plan, problem.stage_cost,
                              action_chunk=10, state_blocks=blocks)
    got = sb(v)
    np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(np.asarray(got.argmin), np.asarray(ref.argmin))
    if blocks == (5, 5):
        # per-(block, chunk) bases absorb cross-axis drift: the residual
        # band must be narrower than the unblocked one on the drifting axis
        sb0 = build_stencil_backup(problem.plan, problem.stage_cost,
                                   action_chunk=10)
        assert sum(len(t) for t in sb.valid_taps) < \
            sum(len(t) for t in sb0.valid_taps)


def test_multiaxis_blocked_edge_split_matches_gather():
    problem = kirk.build(kirk.KirkConfig(N=10, dx=20, du=50))
    v = jnp.asarray(np.random.default_rng(6).normal(size=(20, 20)), jnp.float32)
    ref = bellman_backup(v, problem.plan, problem.stage_cost)
    got = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10, state_blocks=(4, 4),
                               edge_split=True)(v)
    np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                               rtol=3e-6, atol=3e-6)
    assert (np.asarray(got.argmin) == np.asarray(ref.argmin)).mean() > 0.998


def test_multiaxis_rolled_rejected():
    problem = kirk.build(kirk.KirkConfig(N=10, dx=20, du=50))
    with pytest.raises(ValueError, match="contiguous"):
        build_stencil_backup(problem.plan, problem.stage_cost,
                             action_chunk=10, rolled=True,
                             state_blocks=(2, 2))


@pytest.mark.parametrize("blocks", [1, 4])
def test_rolled_flat_mode_matches_unrolled(blocks):
    problem = kirk.build(kirk.KirkConfig(N=10, dx=20, du=50))
    v = jnp.asarray(np.random.default_rng(2).normal(size=(20, 20)), jnp.float32)
    ref = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10)(v)
    got = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10, rolled=True,
                               state_blocks=blocks)(v)
    np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                               rtol=2e-6, atol=2e-6)
    assert (np.asarray(got.argmin) == np.asarray(ref.argmin)).mean() > 0.998


def test_rolled_6d_matches_unrolled():
    from ocdp_tpu.models import attitude

    cfg = attitude.AttitudeConfig(n_mesh_w=4, n_mesh_q=3, T_final=0.25,
                                  n_mesh_t=5)
    grid, plan, cost = attitude.build_full(cfg)
    v = jnp.asarray(np.random.default_rng(3).normal(size=grid.shape),
                    jnp.float32)
    ref = build_stencil_backup(plan, cost, action_chunk=27)(v)
    got = build_stencil_backup(plan, cost, action_chunk=9, rolled=True)(v)
    np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                               rtol=3e-6, atol=3e-6)
    assert (np.asarray(got.argmin) == np.asarray(ref.argmin)).mean() > 0.99


@pytest.mark.parametrize("blocks", [1, 4])
def test_edge_split_matches_gather(blocks):
    """Clamp-split: extrapolating queries served by fixed edge taps."""
    problem = kirk.build(kirk.KirkConfig(N=10, dx=20, du=50))
    v = jnp.asarray(np.random.default_rng(4).normal(size=(20, 20)), jnp.float32)
    ref = bellman_backup(v, problem.plan, problem.stage_cost)
    sb = build_stencil_backup(problem.plan, problem.stage_cost,
                              action_chunk=10, state_blocks=blocks,
                              edge_split=True)
    assert any(lo or hi for lo, hi in sb.edge_taps)
    # the interior band must be strictly narrower than the unsplit band
    sb0 = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10, state_blocks=blocks)
    assert sum(len(t) for t in sb.valid_taps) < sum(len(t) for t in sb0.valid_taps)
    got = sb(v)
    np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                               rtol=3e-6, atol=3e-6)
    assert (np.asarray(got.argmin) == np.asarray(ref.argmin)).mean() > 0.998


def test_unroll_blocks_matches_scanned_blocks():
    """unroll_blocks=True (Python-unrolled block sweep inside the chunk
    scan) must be bitwise-equal to the lax.map block sweep."""
    problem = kirk.build(kirk.KirkConfig(N=10, dx=24, du=40))
    v = jnp.asarray(np.random.default_rng(1).normal(size=(24, 24)),
                    jnp.float32)
    ref = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10, state_blocks=(2, 2))(v)
    got = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10, state_blocks=(2, 2),
                               unroll_blocks=True)(v)
    np.testing.assert_array_equal(np.asarray(got.values),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(np.asarray(got.argmin),
                                  np.asarray(ref.argmin))


def test_lerp_select_matches_gather_to_ulp():
    """The opt-in select-then-lerp tap combine is ~1-ulp FMA-unstable
    across program shapes (stencil.py lerp_select field comment) — verify
    values stay ulp-close to the oracle and argmin flips are rare
    near-ties only."""
    problem = kirk.build(kirk.KirkConfig(N=10, dx=24, du=40))
    v = jnp.asarray(np.random.default_rng(2).normal(size=(24, 24)),
                    jnp.float32)
    ref = bellman_backup(v, problem.plan, problem.stage_cost)
    got = build_stencil_backup(problem.plan, problem.stage_cost,
                               action_chunk=10, lerp_select=True)(v)
    np.testing.assert_allclose(np.asarray(got.values),
                               np.asarray(ref.values), rtol=1e-6, atol=1e-5)
    assert (np.asarray(got.argmin) != np.asarray(ref.argmin)).mean() < 5e-3
