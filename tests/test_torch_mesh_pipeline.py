"""The port's ``BatchProcessor`` under a mesh (``parallel/pipeline.py`` with
``mesh=``; the kernels' plain versions on meshes of CPU devices) in both modes, LTU
and host-scored, against the JAX package's ``BatchProcessor(fmt,
mesh=make_mesh(8))``, restored through ``UntransformBatchProcessor``. Payloads come
from the generators with numpy seeds; settings and bytes must be equal (exact)."""

import pytest
import torch

from dxt_lossless_transform_tpu.estimate import ZstdEstimation as JaxZstd
from dxt_lossless_transform_tpu.parallel import make_mesh as jax_make_mesh
from dxt_lossless_transform_tpu.parallel import pipeline as jax_pipeline
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.parallel import (
    BatchProcessor, UntransformBatchProcessor, make_mesh,
)

CPU = torch.device("cpu")
FORMATS = ("bc1", "bc2", "bc3", "bc4", "bc5")
MESHES = {"1x8": 8, "3x2": 6}


def _mesh(name: str):
    return make_mesh(devices=[CPU] * MESHES[name])


def _payload(fmt: str, n: int, seed: int) -> bytes:
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    size = 8 if fmt in ("bc1", "bc4") else 16
    return gen(n, seed=seed) if gen else testgen.bc_blocks(n, size, seed=seed)


def _corpus(fmt: str) -> list:
    """Four ragged files of one bucket (one batch, one JAX compile) and an empty
    one; the (3, 2) mesh pads the batch to 6 files."""
    out = [_payload(fmt, n, seed=n) for n in (100, 1500, 2048, 700)]
    return out[:1] + [b""] + out[1:]


_JAX_BATCH: dict = {}


def _jax_batch(fmt: str) -> list:
    """JAX's ``BatchProcessor(fmt, mesh=make_mesh(8))`` on :func:`_corpus`, once per
    format (it compiles each batch shape under the mesh)."""
    if fmt not in _JAX_BATCH:
        _JAX_BATCH[fmt] = jax_pipeline.BatchProcessor(
            fmt, mesh=jax_make_mesh(8), max_batch=4).process(_corpus(fmt))
    return _JAX_BATCH[fmt]


@pytest.mark.parametrize("mesh_name", ["1x8", "3x2"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_batch_processor_under_a_mesh_matches_jax(fmt, mesh_name):
    data = _corpus(fmt)
    want = _jax_batch(fmt)
    proc = BatchProcessor(fmt, mesh=_mesh(mesh_name), max_batch=4, device="cuda")
    assert proc.device == CPU  # the mesh's devices, not the device argument
    got = proc.process(data)
    assert [r.index for r in got] == list(range(len(data)))
    for j, r in zip(want, got):
        assert convert.from_reference(j.settings) == r.settings, r.index
        assert j.transformed == r.transformed, r.index
    back = UntransformBatchProcessor(fmt, max_batch=4, device="cpu").process(
        [(r.transformed, r.settings) for r in got])
    assert back == data


@pytest.mark.parametrize("fmt", ["bc1", "bc3", "bc5"])
def test_host_scored_batch_processor_under_a_mesh_matches_jax(fmt, monkeypatch):
    monkeypatch.setenv("DLT_DEVICE_MIN_BYTES", "0")  # JAX: every payload batched
    data = _corpus(fmt)
    want = jax_pipeline.BatchProcessor(fmt, mesh=jax_make_mesh(8), estimator=JaxZstd(1),
                                       max_batch=4).process(data)
    got = BatchProcessor(fmt, mesh=_mesh("3x2"), estimator=ZstdEstimation(1),
                         max_batch=4).process(data)
    for j, r in zip(want, got):
        assert convert.from_reference(j.settings) == r.settings, r.index
        assert j.transformed == r.transformed, r.index
    back = UntransformBatchProcessor(fmt, device="cpu").process(
        [(r.transformed, r.settings) for r in got])
    assert back == data
