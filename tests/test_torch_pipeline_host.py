"""The port's corpus batch pipeline in host-scored mode (``BatchProcessor(fmt,
estimator=ZstdEstimation(1))``, the zstd presets; plain versions on the CPU) against
the JAX package's, as ``tests/test_parallel.py:358-456`` drives it: with the JAX
package's device threshold at 0, so that every payload goes through its batch's
region rows, and at its default, where it sends payloads below 1 MiB to its host
runtime. The port batches every payload either way. Payloads come from the
generators with numpy seeds (ragged files, ``max_batch`` below the file count, one
empty payload); settings and bytes must be equal (exact)."""

import pytest

from dxt_lossless_transform_tpu.estimate import ZstdEstimation as JaxZstd
from dxt_lossless_transform_tpu.parallel import pipeline as jax_pipeline
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.ops import auto, bc45
from dxt_lossless_transform_tpu_torch.parallel import BatchProcessor

PER_FILE = {"bc1": auto.transform_bc1_auto, "bc2": auto.transform_bc2_auto,
            "bc3": auto.transform_bc3_auto, "bc4": bc45.transform_bc4_auto,
            "bc5": bc45.transform_bc5_auto}


def _payloads(fmt: str) -> list:
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    size = 8 if fmt in ("bc1", "bc4") else 16
    out = [gen(n, seed=100 + n) if gen else testgen.bc_blocks(n, size, seed=n)
           for n in (64, 600, 2048, 2049, 3000)]
    return out[:2] + [b""] + out[2:]


@pytest.mark.parametrize("threshold", ["0", None], ids=["batched", "per-file"])
@pytest.mark.parametrize("fmt", list(PER_FILE))
def test_host_scored_matches_jax(fmt, threshold, monkeypatch):
    if threshold is None:
        monkeypatch.delenv("DLT_DEVICE_MIN_BYTES", raising=False)
    else:
        monkeypatch.setenv("DLT_DEVICE_MIN_BYTES", threshold)
    data = _payloads(fmt)
    want = jax_pipeline.BatchProcessor(fmt, estimator=JaxZstd(1), max_batch=2).process(data)
    est = ZstdEstimation(1)
    proc = BatchProcessor(fmt, estimator=est, max_batch=2, device="cpu")
    got = proc.process(data)
    assert [r.index for r in got] == list(range(len(data)))
    for j, r in zip(want, got):
        assert convert.from_reference(j.settings) == r.settings, r.index
        assert j.transformed == r.transformed, r.index
    assert got[2].transformed == b""
    assert proc.batches == 3
    # the same winner as the per-file auto-search with the same estimator
    for r, payload in zip(got, data):
        if payload:
            assert PER_FILE[fmt](payload, est, device="cpu") == (r.transformed,
                                                                r.settings)
