"""The port's process group (``parallel/distributed.py``) and a mesh across
processes: two processes over gloo on the CPU, 4 CPU devices each, one ``(1, 8)``
mesh whose blocks axis crosses them (halos by ``batch_isend_irecv``, partial counts
by ``all_reduce``, the transformed batch on every rank). The sharded BC1 step's
outputs, on each rank, must equal the single-process step's, and those the bytes the
JAX package's pipeline serializes from its step (exact). The counterpart of
``tests/test_distributed_multiprocess.py``."""

import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dxt_lossless_transform_tpu.parallel import bc1_auto_step_single as jax_single
from dxt_lossless_transform_tpu_torch.parallel import (
    bc1_auto_step_single, initialize, is_primary,
)

from jax_batch_bytes import jax_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_single_process_is_not_distributed():
    assert initialize(num_processes=1) is False
    assert initialize() is False  # no cluster given
    assert is_primary()


def test_two_processes_one_mesh_match_the_single_process_step():
    worker = os.path.join(REPO, "scripts", "torch_distributed_worker.py")
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "out")
        procs = [subprocess.Popen([sys.executable, worker, coordinator, "2", str(i), prefix],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for i in range(2)]
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (so, se) in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{so}\n{se}"
        got = [dict(np.load(f"{prefix}.{i}.npz")) for i in range(2)]

    B, nblocks = 4, 4096
    flats = np.random.default_rng(17).integers(0, 2**32, (B, 2 * nblocks), dtype=np.uint32)
    valid = [4 * nblocks, 4 * nblocks - 500, 4 * 3000, 4 * 5]
    for b in range(B):
        n = valid[b] // 4
        want, best = bc1_auto_step_single(torch.from_numpy(flats[b].view(np.int32)),
                                          valid[b])
        jax_want = jax.device_get(jax_single(jnp.asarray(flats[b]), valid[b]))
        assert int(best) == int(jax_want[-1])
        assert want.numpy().tobytes() == jax_bytes("bc1", jax_want[:-1], jax_want[-1], n)
        for rank_out in got:
            assert rank_out["best"][b] == int(best)
            np.testing.assert_array_equal(rank_out["rows"][b, :8 * n], want.numpy())
