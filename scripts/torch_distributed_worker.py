#!/usr/bin/env python3
"""Worker of the port's multi-process test: one rank of a CPU process group.

    python scripts/torch_distributed_worker.py COORDINATOR NUM_PROCS PROC_ID OUT_PREFIX

Each process joins a gloo group at ``tcp://COORDINATOR`` (``parallel.initialize``),
brings 4 CPU devices to one global ``(files, blocks)`` mesh (``make_mesh``: ``(1, 8)``
for two processes, the blocks axis across them), runs the sharded BC1 auto-step on a
batch made from a fixed numpy seed, identical on every process, and writes the
outputs it got back, each file's transformed bytes and its pick, to
``OUT_PREFIX.<proc_id>.npz``: every rank gets them whole.
The counterpart of ``scripts/distributed_worker.py``.
"""

import sys

import numpy as np
import torch


def main() -> int:
    coordinator, num_procs, proc_id, out_prefix = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)

    import torch.distributed as dist

    from dxt_lossless_transform_tpu_torch.parallel import (
        bc1_auto_step, initialize, is_primary, make_mesh,
    )

    assert initialize(coordinator_address=coordinator, num_processes=num_procs,
                      process_id=proc_id, device="cpu")
    assert is_primary() == (proc_id == 0)
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"files": 1, "blocks": 4 * num_procs}, mesh.shape

    B, nblocks = 4, 4096
    rng = np.random.default_rng(17)
    flats = rng.integers(0, 2**32, (B, 2 * nblocks), dtype=np.uint32)
    valid = [4 * nblocks, 4 * nblocks - 500, 4 * 3000, 4 * 5]
    out = bc1_auto_step(mesh)(torch.from_numpy(flats.view(np.int32)), valid)
    np.savez(f"{out_prefix}.{proc_id}.npz",
             **{name: t.numpy() for name, t in zip(("rows", "best"), out)})
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
