"""The end of the device-scored batch step (``ops/cuda/shuffle.py`` ``transform_rows``;
its plain versions on the CPU): a batch of files, each transformed under its own
winner into its row, must equal the per-file transform of the JAX package's oracle
(``dxt_lossless_transform_tpu/oracle``) byte for byte, for every FAST candidate
(BC4/BC5: both ``split_endpoints``), with mixed winners in one batch and block counts
odd, 1 and several lengths in one bucket; the batch processor ships none of a row's
padding; ``batch.files_device_bytes`` counts the files whose bytes the rows form
wrote. Inputs come from numpy seeds; every comparison is exact."""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu import settings as jax_settings
from dxt_lossless_transform_tpu.oracle import bc1 as obc1, bc2 as obc2, bc3 as obc3
from dxt_lossless_transform_tpu.oracle import bc4 as obc45
from dxt_lossless_transform_tpu_torch import backend, convert
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.ops.cuda import shuffle
from dxt_lossless_transform_tpu_torch.parallel import (
    BatchProcessor, make_mesh, pipeline, sharded,
)
from dxt_lossless_transform_tpu_torch.utils import testgen

FORMATS = ("bc1", "bc2", "bc3", "bc4", "bc5")
BLOCK_SIZE = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16}
ORACLE = {"bc1": obc1.transform, "bc2": obc2.transform, "bc3": obc3.transform,
          "bc4": obc45.transform_bc4, "bc5": obc45.transform_bc5}


def _oracle(fmt: str, payload: bytes, settings) -> bytes:
    """The JAX package's oracle transform under the port's ``settings``."""
    return ORACLE[fmt](payload, convert.to_reference(settings, jax_settings))
# block counts of one batch's rows: the whole bucket, 1, odd and even lengths, 0 (a
# row that holds no file)
BUCKET = 2049
LENGTHS = {"full and one": [BUCKET, 1, 2, BUCKET - 1],
           "odd": [3, 5, 1025, 2047],
           "several": [64, 0, 513, 1000, 7, 2048]}


def _processor_candidates(fmt: str):
    """The processor's FAST candidates (BC4/BC5: both ``split_endpoints``) and the
    step's keys of them."""
    cfg = pipeline._FORMATS[fmt]
    return cfg["candidates"], [cfg["key"](c) for c in cfg["candidates"]]


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_transform_rows_match_the_per_file_transform(fmt, lengths):
    """Every candidate is some row's winner: each row's first block_size·n bytes are
    the oracle's transform of the row's n blocks under its winner."""
    bs = BLOCK_SIZE[fmt]
    settings, keys = _processor_candidates(fmt)
    ns = LENGTHS[lengths] * len(keys)
    rng = np.random.default_rng(len(ns) * bs)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (len(ns), bs * BUCKET // 4),
                                      dtype=np.int32))
    best = torch.from_numpy(rng.permutation(
        [k for k in range(len(keys)) for _ in LENGTHS[lengths]]))
    rows = shuffle.transform_rows(fmt, x, ns, best, keys)
    assert rows.shape == (len(ns), bs * BUCKET) and rows.dtype == torch.uint8
    data = x.view(torch.uint8).numpy()
    for r, (n, k) in enumerate(zip(ns, best.tolist())):
        want = _oracle(fmt, data[r, :bs * n].tobytes(), settings[k])
        assert rows[r, :bs * n].numpy().tobytes() == want, (r, n, settings[k])


@pytest.mark.parametrize("fmt", FORMATS)
def test_batch_ships_no_padding(fmt, monkeypatch):
    """The rows' padding filled with a marker after the step: every shipped file is
    its payload's length and the oracle's transform under its settings."""
    bs = BLOCK_SIZE[fmt]
    real = sharded.transform_rows

    def marked(fmt_, x, ns, best, candidates):
        rows = real(fmt_, x, ns, best, candidates)
        for r, n in enumerate(ns):
            rows[r, bs * n:] = 0xA5
        return rows

    monkeypatch.setattr(sharded, "transform_rows", marked)
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    data = [gen(n, seed=n) if gen else testgen.bc_blocks(n, bs, seed=n)
            for n in (1, 3, 100, 2047, 2049, 5000)] + [b""]
    got = BatchProcessor(fmt, max_batch=3, device="cpu").process(data)
    assert [r.index for r in got] == list(range(len(data)))
    for r, payload in zip(got, data):
        assert len(r.transformed) == len(payload)
        if payload:
            assert r.transformed == _oracle(fmt, payload, r.settings)


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_files_device_bytes_counts_the_files_the_rows_form_wrote(fmt, mode):
    """The call's non-empty files, device- and host-scored, under a mesh too (its
    padding copies not counted)."""
    bs = BLOCK_SIZE[fmt]
    data = [testgen.bc_blocks(n, bs, seed=n) for n in (5, 2049, 1, 700)] + [b"", b""]
    estimator = None if mode == "device" else ZstdEstimation(1)
    backend.reset_counters()
    BatchProcessor(fmt, max_batch=3, device="cpu", estimator=estimator).process(data)
    assert backend.counters()["batch.files_device_bytes"] == 4
    backend.reset_counters()
    BatchProcessor(fmt, mesh=make_mesh(devices=[torch.device("cpu")] * 6), max_batch=3,
                   estimator=estimator).process(data)
    assert backend.counters()["batch.files_device_bytes"] == 4
