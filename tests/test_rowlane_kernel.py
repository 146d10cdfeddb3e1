"""The row/lane kernel's wrapper and Triton route (ops/pallas_backup6.py).

CPU cases run the kernel in the Pallas interpreter (an explicit
``interpret=True``) over block shapes, the padded table layout and the
narrow argmin, check that the wrapper refuses what Triton cannot take,
and lower the compiled kernel for CUDA (Triton IR is built on any host).
Cases marked ``gpu`` compile it for the card; ``chip_smoke.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocdp_tpu.models import attitude, pos_att
from ocdp_tpu.ops.backup import bellman_backup
from ocdp_tpu.ops.pallas_backup6 import PallasBackup6D


def _attitude(nw=5, nq=4):
    cfg = attitude.AttitudeConfig(n_mesh_w=nw, n_mesh_q=nq)
    grid, plan, cost = attitude.build_full(cfg)
    full = sum(jnp.broadcast_to(t, plan.query_shape) for t in cost)
    return grid, plan, cost, full


def _channel(channel="x"):
    cfg = pos_att.PosAttConfig(n_mesh_x=8, n_mesh_v=8, n_mesh_t=6,
                               n_mesh_w=5)
    return cfg, pos_att.build_channel(cfg, channel)


def _oracle_check(out, ref, min_agree=1.0):
    ref_v = np.asarray(ref.values)
    scale = max(1.0, float(np.abs(ref_v).max()))
    np.testing.assert_allclose(np.asarray(out.values), ref_v,
                               rtol=1e-6, atol=1e-6 * scale)
    agree = (np.asarray(out.argmin) == np.asarray(ref.argmin)).mean()
    assert agree >= min_agree, agree


@pytest.mark.parametrize("row_tile,lane_block",
                         [(8, 64), (4, 16), (16, 32), (2, 128)])
def test_block_shapes_match_oracle(row_tile, lane_block):
    """Any power-of-two block shape tiles the (rows, lanes) table exactly:
    padded rows/lanes of the last blocks never leak into real cells."""
    cfg, p = _channel()
    bk = pos_att.build_channel_rowlane_backup(
        cfg, p, row_tile=row_tile, lane_block=lane_block, interpret=True)
    v = jax.random.uniform(jax.random.PRNGKey(row_tile), p.grid.shape,
                           jnp.float32) * 5.0
    _oracle_check(bk(v), bellman_backup(v, p.plan, p.stage_cost))


@pytest.mark.parametrize("lane_block", [16, 32, 64, 128])
def test_padded_table_layout(lane_block):
    """Every shifted read of every real cell stays inside the zero-padded
    table (no load needs a mask), and the padded-carry layout round-trips
    the values with zeros everywhere else."""
    grid, plan, cost, _ = _attitude()
    for carry in (False, True):
        bk = PallasBackup6D(plan, cost, lane_block=lane_block,
                            carry_padded=carry, interpret=True)
        T, BL = bk.row_tile, bk.lane_block
        assert bk.NEp % BL == 0 and bk.NEp >= bk.NE
        assert bk.lane_pad % BL == 0 and bk.table_width % BL == 0
        assert bk.lane_pad + min(bk.lane_deltas) >= 0
        assert bk.lane_pad + bk.NEp + max(bk.lane_deltas) <= bk.table_width
        assert bk.pad_top + bk.d_min >= 0
        assert bk.pad_top + bk.NWp + bk.d_max <= bk.carry_rows
        if carry:
            assert bk.pad_top % T == 0 and bk.carry_rows % T == 0
        v = np.random.default_rng(0).uniform(1, 2, grid.shape)
        tab = np.asarray(bk.pad_carry(jnp.asarray(v, jnp.float32)))
        assert tab.shape == bk.carry_shape
        real = np.asarray(bk.unpad_values(tab))
        np.testing.assert_array_equal(real, v.reshape(bk.NW, bk.NE)
                                      .astype(np.float32))
        assert tab.sum(dtype=np.float64) == pytest.approx(
            real.sum(dtype=np.float64))


@pytest.mark.parametrize("carry", [False, True])
def test_uint8_argmin_bitwise(carry):
    """The narrow uint8 argmin output equals the int32 one, values equal,
    in both table modes."""
    cfg, p = _channel("y")
    b32 = pos_att.build_channel_rowlane_backup(cfg, p, interpret=True,
                                               carry_padded=carry)
    b8 = pos_att.build_channel_rowlane_backup(cfg, p, interpret=True,
                                              carry_padded=carry,
                                              argmin_dtype=jnp.uint8)
    v = jax.random.normal(jax.random.PRNGKey(7), p.grid.shape, jnp.float32)
    r32, r8 = b32(v), b8(v)
    assert r8.argmin.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(r32.values),
                                  np.asarray(r8.values))
    np.testing.assert_array_equal(np.asarray(r32.argmin),
                                  np.asarray(r8.argmin, np.int32))


@pytest.mark.parametrize("kw", [{"row_tile": 6}, {"lane_block": 48}])
def test_rejects_non_power_of_two_blocks(kw):
    _, plan, cost, _ = _attitude()
    with pytest.raises(ValueError, match="powers of two"):
        PallasBackup6D(plan, cost, interpret=True, **kw)


def test_compiled_kernel_refuses_the_cpu():
    """Without interpret=True the kernel is compiled for the GPU; on a CPU
    backend it refuses to run instead of falling back to the
    interpreter."""
    grid, plan, cost, _ = _attitude()
    bk = PallasBackup6D(plan, cost)
    assert bk.interpret is False
    with pytest.raises(ValueError, match="interpret"):
        bk(jnp.zeros(grid.shape, jnp.float32))


def _lower_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("case", ["attitude", "attitude_carry_uint8",
                                  "attitude_min_only", "pos_att"])
def test_lowers_to_triton_for_cuda(case):
    """The compiled route lowers to a Triton custom call for CUDA — the
    check a CPU host can make of the GPU path (Triton IR is built here;
    only PTX generation needs the card)."""
    if case == "pos_att":
        cfg, p = _channel()
        bk = pos_att.build_channel_rowlane_backup(cfg, p, device=None)
        txt = _lower_cuda(lambda b, v: b(v), bk,
                          jax.ShapeDtypeStruct(p.grid.shape, jnp.float32))
    else:
        carry = case == "attitude_carry_uint8"
        grid, plan, cost, _ = _attitude()
        bk = PallasBackup6D(plan, cost, carry_padded=carry,
                            argmin_dtype=jnp.uint8 if carry else jnp.int32,
                            track_argmin=case != "attitude_min_only")
        if carry:
            txt = _lower_cuda(lambda b, t: b.sweep_carry(t), bk,
                              jax.ShapeDtypeStruct(bk.carry_shape,
                                                   jnp.float32))
        else:
            txt = _lower_cuda(lambda b, v: b(v), bk,
                              jax.ShapeDtypeStruct(grid.shape, jnp.float32))
    assert "triton" in txt


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["attitude", "pos_att"])
def test_gpu_kernel_matches_oracle(gpu_backend, case):
    """The compiled kernel vs the gather oracle on the card (values to
    f32 rounding; argmin flips only at float near-ties)."""
    if case == "pos_att":
        cfg, p = _channel()
        bk = pos_att.build_channel_rowlane_backup(cfg, p)
        plan, full, shape = p.plan, p.stage_cost, p.grid.shape
    else:
        grid, plan, cost, full = _attitude()
        bk = PallasBackup6D(plan, cost)
        shape = grid.shape
    v = jax.random.uniform(jax.random.PRNGKey(3), shape, jnp.float32) * 5.0
    out = jax.jit(lambda b, x: b(x))(bk, v)
    ref = jax.jit(bellman_backup)(v, plan, full)
    ref_v = np.asarray(ref.values)
    np.testing.assert_allclose(np.asarray(out.values), ref_v, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref_v).max()))
    agree = (np.asarray(out.argmin) == np.asarray(ref.argmin)).mean()
    assert agree >= 0.999, agree


@pytest.mark.gpu
def test_gpu_carry_matches_plain(gpu_backend):
    """Padded-carry and plain table modes agree on the card."""
    grid, plan, cost, _ = _attitude()
    b0 = PallasBackup6D(plan, cost, argmin_dtype=jnp.uint8)
    b1 = PallasBackup6D(plan, cost, argmin_dtype=jnp.uint8,
                        carry_padded=True)
    v = jax.random.uniform(jax.random.PRNGKey(4), grid.shape, jnp.float32)
    r0 = jax.jit(lambda b, x: b(x))(b0, v)
    r1 = jax.jit(lambda b, x: b(x))(b1, v)
    np.testing.assert_allclose(np.asarray(r0.values), np.asarray(r1.values),
                               rtol=1e-6, atol=1e-6)
    agree = (np.asarray(r0.argmin) == np.asarray(r1.argmin)).mean()
    assert agree >= 0.999, agree


@pytest.mark.gpu
def test_gpu_min_only_matches_tracking(gpu_backend):
    """Min-only sweeps give the tracking kernel's values on the card."""
    grid, plan, cost, _ = _attitude()
    v = jax.random.uniform(jax.random.PRNGKey(5), grid.shape, jnp.float32)
    run = jax.jit(lambda b, x: b(x))
    r0 = run(PallasBackup6D(plan, cost), v)
    r1 = run(PallasBackup6D(plan, cost, track_argmin=False), v)
    np.testing.assert_allclose(np.asarray(r0.values), np.asarray(r1.values),
                               rtol=1e-6, atol=1e-6)
    assert not np.any(np.asarray(r1.argmin))
