"""Worker process for the 2-process jax.distributed test.

Usage: python _distributed_worker.py <coordinator> <num_procs> <pid> <out.npz>

Each process brings 4 virtual CPU devices; the global mesh has
num_procs * 4 devices. Runs a sharded Kirk solve over the GLOBAL mesh (the
all_gather collective crosses the process boundary — the DCN analog) and
writes the replicated result to ``out.npz``.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    coordinator, num_procs, pid, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from ocdp_tpu.models import kirk
    from ocdp_tpu.parallel import (
        initialize_distributed,
        make_mesh,
        value_iteration_finite_sharded,
    )

    initialize_distributed(coordinator_address=coordinator,
                           num_processes=num_procs, process_id=pid)
    assert jax.process_count() == num_procs
    assert len(jax.devices()) == num_procs * 4   # global devices
    assert len(jax.local_devices()) == 4

    problem = kirk.build(kirk.KirkConfig(N=12, dx=16, du=12))
    mesh = make_mesh(("s",))                      # all 8 global devices
    res = value_iteration_finite_sharded(
        problem.plan, problem.stage_cost, 11, mesh)

    # halo-exchange engine across the SAME process boundary: the per-sweep
    # ppermute of boundary slabs is the ring collective riding the
    # cross-process link here. Outputs stay sharded over "s" (not fully
    # addressable), so each process saves its OWN row shards for the host
    # to check.
    from ocdp_tpu.parallel import value_iteration_finite_halo

    problem2 = kirk.build(kirk.KirkConfig(N=6, dx=64, du=12))
    res_h = value_iteration_finite_halo(
        problem2.plan, problem2.stage_cost, 5, mesh, action_chunk=12)
    starts, vals, args = [], [], []
    for sh in res_h.values.addressable_shards:
        starts.append(sh.index[0].start or 0)
        vals.append(np.asarray(sh.data))
    for sh in res_h.argmin.addressable_shards:
        args.append(np.asarray(sh.data))

    # outputs of the all_gather engine are replicated -> addressable
    np.savez(out_path,
             values=np.asarray(res.values),
             argmin=np.asarray(res.argmin),
             halo_starts=np.asarray(starts),
             halo_values=np.stack(vals),
             halo_argmin=np.stack(args))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
