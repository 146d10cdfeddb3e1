"""Measured communication accounting for the sharded engines.

The multi-chip budget math (NOTES.md) needs a comms TERM, not an adjective:
these helpers compile a sharded sweep and count the bytes every
``collective-permute`` in the optimized HLO actually moves (the halo
exchange is the only collective in a finite halo sweep), cross-checked
against the analytic halo size from the kernel's tap reach.
"""

from __future__ import annotations

import re

__all__ = ["collective_permute_bytes", "measure_halo6_comms"]

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "s16": 2,
                "f16": 2, "u8": 1, "s8": 1, "pred": 1}


def collective_permute_bytes(hlo_text: str) -> int:
    """Total bytes sourced by ``collective-permute`` ops in optimized HLO.

    Parses each op's RESULT shape from its defining line — what XLA will
    actually put on the wire per execution, per participating device.
    Counts BOTH the sync form (``collective-permute(`` — what the CPU
    backend emits) and the async form accelerator backends rewrite it into
    (``collective-permute-start(``; its result is a tuple whose first
    element is the payload, which is what the leading-shape parse picks
    up). ``collective-permute-done`` carries no payload of its own and is
    deliberately not matched — counting it would double every transfer.
    """
    total = 0
    for m in re.finditer(r"collective-permute(?:-start)?\(", hlo_text):
        line_start = hlo_text.rfind("\n", 0, m.start()) + 1
        line = hlo_text[line_start:m.start()]
        shape = re.search(r"(f32|s32|u32|bf16|s16|f16|u8|s8|pred)"
                          r"\[([\d,]*)\]", line)
        if not shape:
            continue
        dtype, dims = shape.groups()
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def measure_halo6_comms(cfg, n_dev: int, axis_name: str = "s",
                        **kernel_kw) -> dict:
    """Compile ONE row-sharded 6-D halo sweep and account its comms.

    Returns per-device per-sweep ppermute bytes from the compiled HLO,
    the analytic halo size ((pad_top + pad_bot) rows x NEp lanes x 4 B)
    it must equal, and the analytic per-sweep FLOP count (XLA's own
    ``cost_analysis`` cannot see inside the Pallas custom call).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from ..models import attitude
    from .halo6 import _build_rowsharded, _make_halo_pad

    grid, plan, cost = attitude.build_full(cfg)
    cells = int(np.prod(grid.shape))
    bk, B, lo, hi = _build_rowsharded(plan, cost, n_dev, kernel_kw)

    def one_sweep(v_blk, *args_l):
        halo_pad = _make_halo_pad(axis_name, n_dev, lo, hi)
        return bk._sweep_padded(halo_pad(v_blk), args_l, B)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), (axis_name,))
    rows = P(axis_name, None)
    n_rep = bk.n_replicated_args
    in_specs = [rows] * (1 + len(bk.sweep_args) - n_rep) \
        + [P(None, None)] * n_rep
    fn = jax.jit(jax.shard_map(one_sweep, mesh=mesh,
                               in_specs=tuple(in_specs),
                               out_specs=(rows, rows), check_vma=False))
    v0 = jnp.zeros((bk.NWp, bk.NEp), jnp.float32)
    hlo = fn.lower(v0, *bk.sweep_args).compile().as_text()

    taps = len(bk.row_deltas) * max(len(bk.lane_combos), 1)
    return {
        "cells": cells,
        "n_dev": n_dev,
        "halo_rows": (lo, hi),
        "NEp": bk.NEp,
        "permute_bytes_per_dev_sweep_hlo": collective_permute_bytes(hlo),
        "permute_bytes_per_dev_sweep_analytic": (lo + hi) * bk.NEp * 4,
        "flops_per_sweep_analytic": cells * bk.n_actions * 2
        + cells * taps * 2,
    }
