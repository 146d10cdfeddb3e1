"""Comms accounting (parallel/comms.py): the compiled-HLO ppermute byte
count must equal the analytic halo size — the measured comms term of the
multi-device budget math."""

import numpy as np

from ocdp_tpu.models.attitude import AttitudeConfig
from ocdp_tpu.parallel.comms import (collective_permute_bytes,
                                     measure_halo6_comms)


def test_hlo_permute_bytes_match_analytic():
    cfg = AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
    m = measure_halo6_comms(cfg, 2, row_tile=8, interpret=True)
    assert m["permute_bytes_per_dev_sweep_hlo"] == \
        m["permute_bytes_per_dev_sweep_analytic"]
    assert m["permute_bytes_per_dev_sweep_hlo"] > 0
    # comms is orders of magnitude under compute even at this tiny size
    assert m["flops_per_sweep_analytic"] > \
        100 * m["permute_bytes_per_dev_sweep_hlo"]


def test_collective_permute_parser():
    hlo = """
  %x = f32[16,128]{1,0} collective-permute(%a), source_target_pairs={{0,1}}
  %y = u8[8,128]{1,0} collective-permute(%b), source_target_pairs={{1,0}}
"""
    assert collective_permute_bytes(hlo) == 16 * 128 * 4 + 8 * 128


def test_collective_permute_parser_async_form():
    # accelerator backends rewrite sync permutes into -start/-done pairs
    # in optimized HLO; the parser must count the start's payload (first
    # tuple element) exactly once and ignore the payload-free -done op.
    hlo = """
  %cps = (f32[24,128]{1,0}, f32[24,128]{1,0}, u32[], u32[]) collective-permute-start(%a), source_target_pairs={{0,1},{1,0}}
  %cpd = f32[24,128]{1,0} collective-permute-done(%cps)
"""
    assert collective_permute_bytes(hlo) == 24 * 128 * 4
