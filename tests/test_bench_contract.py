"""Guard the driver contract: bench.py prints one JSON line with the
required keys, and the numpy baseline stage runs (tiny config)."""

import json
import subprocess
import sys


def test_bench_baseline_helper_runs():
    import bench as bench_mod
    from ocdp_tpu.models import kirk

    cfg = kirk.KirkConfig(N=6, dx=12, du=10)
    dt = bench_mod.numpy_baseline_stage_seconds(cfg, n_trials=1)
    assert dt > 0


def test_bench_json_contract_keys():
    # static check of the printed dict keys without paying a solve
    import ast
    import inspect

    import bench as bench_mod

    src = inspect.getsource(bench_mod.main)
    keys = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
    assert {"metric", "value", "unit", "vs_baseline"} <= keys
