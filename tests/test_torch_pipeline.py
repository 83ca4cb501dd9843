"""The port's corpus batch pipeline, device-scored (``parallel/pipeline.py``
``BatchProcessor`` under LTU, ``parallel/sharded.py``; plain versions on the CPU),
against the JAX package's ``BatchProcessor(fmt, mesh=None)``.
Payloads come from the generators with numpy seeds, at the JAX package's own batch
test sizes (``tests/test_parallel.py``): 64, 100, 2048, 2049, 3000 and 5000 blocks
(ragged files in three buckets), ``max_batch`` below the file count, one empty
payload. Settings and bytes must be equal (exact). Candidate lists longer than the
rows kernel's 16, with repeats, are held to JAX under both estimators, on one device
and under a mesh."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu import settings as jax_settings
from dxt_lossless_transform_tpu.estimate import ZstdEstimation as JaxZstd
from dxt_lossless_transform_tpu.parallel import pipeline as jax_pipeline
from dxt_lossless_transform_tpu.parallel import sharded as jax_sharded
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch import backend, convert
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.ops import auto, bc45
from dxt_lossless_transform_tpu_torch.ops.cuda import shuffle
from dxt_lossless_transform_tpu_torch.parallel import (
    BatchProcessor, Bc1BatchProcessor, UntransformBatchProcessor, make_mesh, sharded,
    transform_corpus_bc1,
)
from dxt_lossless_transform_tpu_torch.parallel import pipeline

BLOCK_SIZE = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16}
SIZES = (64, 100, 2048, 2049, 3000, 5000)
PER_FILE = {"bc1": auto.transform_bc1_auto, "bc2": auto.transform_bc2_auto,
            "bc3": auto.transform_bc3_auto, "bc4": bc45.transform_bc4_auto,
            "bc5": bc45.transform_bc5_auto}


def payloads(fmt: str, sizes=SIZES) -> list:
    gen = {"bc1": testgen.bc1_realistic, "bc2": testgen.bc2_realistic,
           "bc3": testgen.bc3_realistic}.get(fmt)
    out = [gen(n, seed=n) if gen else testgen.bc_blocks(n, BLOCK_SIZE[fmt], seed=n)
           for n in sizes]
    return out[:3] + [b""] + out[3:]


def same(jax_results, results) -> None:
    assert [r.index for r in results] == list(range(len(jax_results)))
    for j, r in zip(jax_results, results):
        assert convert.from_reference(j.settings) == r.settings, r.index
        assert j.transformed == r.transformed, r.index


@pytest.mark.parametrize("fmt", list(BLOCK_SIZE))
def test_batch_processor_matches_jax(fmt):
    data = payloads(fmt)
    want = jax_pipeline.BatchProcessor(fmt, mesh=None, max_batch=2).process(data)
    proc = BatchProcessor(fmt, max_batch=2, device="cpu")
    got = proc.process(data)
    same(want, got)
    assert proc.batches == 4  # buckets of 2048 (3 files), 4096 (2) and 8192 (1)
    assert got[3].transformed == b"" and got[3].settings == proc.candidates[-1]
    # the per-file auto-search on each payload picks the same
    for r, payload in zip(got, data):
        if payload and fmt != "bc5":
            assert PER_FILE[fmt](payload, LtuEstimation(), device="cpu") == \
                (r.transformed, r.settings)
    back = UntransformBatchProcessor(fmt, max_batch=2, device="cpu").process(
        [(r.transformed, r.settings) for r in got])
    assert back == data


def test_bc5_sums_red_and_green_scores_as_jax_does():
    """The BC5 batch step scores the red and the green endpoint rows apart and sums
    them (JAX ``sharded.py:665``); the per-file auto scores them joined. Both are
    held to the JAX package's own forms on each payload."""
    data = [testgen.bc_blocks(n, 16, seed=n) for n in (64, 3000)]
    got = BatchProcessor("bc5", device="cpu").process(data)
    for r, payload in zip(got, data):
        flat = jnp.asarray(np.frombuffer(payload, "<u4"))
        want = int(jax.device_get(jax_sharded.bc5_auto_step_single(flat))[-1])
        assert r.settings == pipeline._FORMATS["bc5"]["candidates"][want]


@pytest.mark.parametrize("make", [
    lambda: BatchProcessor("bc1", mesh="mesh", device="cpu"),
    lambda: Bc1BatchProcessor(mesh=object(), device="cpu"),
    lambda: sharded.BatchStep("bc2", sharded._BC2_CANDIDATES, ZstdEstimation(1),
                              mesh="mesh"),
    lambda: transform_corpus_bc1([b""], mesh="mesh", device="cpu"),
], ids=["processor", "bc1-processor", "regions-step", "corpus"])
def test_a_mesh_raises(make):
    """A mesh that is not a ``Mesh`` (``make_mesh``) raises ``TypeError``."""
    with pytest.raises(TypeError, match="expected a Mesh"):
        make()


# more candidates than the rows kernel's 16, repeated, and starting off the FAST
# list's order so that a pick is not its distinct key's index
MANY = {"bc1": 17, "bc3": 20}
_JAX_MANY: dict = {}


def many(fmt: str) -> tuple:
    fast = pipeline._FORMATS[fmt]["candidates"]
    return tuple(itertools.islice(itertools.cycle(fast[1:] + fast), MANY[fmt]))


def jax_many(fmt: str, scorer: str, data) -> list:
    """JAX's ``BatchProcessor`` over :func:`many` on ``data``, once per format and
    estimator."""
    if (fmt, scorer) not in _JAX_MANY:
        _JAX_MANY[fmt, scorer] = jax_pipeline.BatchProcessor(
            fmt, mesh=None, max_batch=2,
            candidates=[convert.to_reference(c, jax_settings) for c in many(fmt)],
            estimator=None if scorer == "ltu" else JaxZstd(1)).process(data)
    return _JAX_MANY[fmt, scorer]


@pytest.mark.parametrize("meshed", [False, True], ids=["one-device", "mesh-3x2"])
@pytest.mark.parametrize("scorer", ["ltu", "zstd1"])
@pytest.mark.parametrize("fmt", ["bc1", "bc3"])
def test_more_candidates_than_the_rows_kernel_takes(fmt, scorer, meshed):
    """17 or 20 candidates with repeats: the rows kernel gets their distinct keys,
    and the picks and bytes are JAX's."""
    data = payloads(fmt, (64, 600, 2049))
    want = jax_many(fmt, scorer, data)
    mesh = make_mesh(devices=[torch.device("cpu")] * 6) if meshed else None
    proc = BatchProcessor(fmt, mesh=mesh, candidates=many(fmt), max_batch=2,
                          estimator=None if scorer == "ltu" else ZstdEstimation(1),
                          device="cpu")
    assert len(proc.candidates) > shuffle.MAX_ROW_CANDIDATES
    same(want, proc.process(data))


def test_unaligned_payload_raises_value_error():
    with pytest.raises(ValueError):
        BatchProcessor("bc3", device="cpu").process([bytes(32), bytes(17)])
    with pytest.raises(ValueError):
        UntransformBatchProcessor("bc1", device="cpu").process(
            [(bytes(12), pipeline._FORMATS["bc1"]["candidates"][0])])


def test_transform_corpus_bc1_and_launches_on_the_cpu():
    backend.reset_launch_counts()
    data = payloads("bc1", (100, 2500))
    got = transform_corpus_bc1(data, device="cpu")
    same(jax_pipeline.transform_corpus_bc1(data), got)
    assert all(count == 0 for count in backend.LAUNCHES.values())


def test_stage_times_are_kept_when_asked():
    proc = BatchProcessor("bc1", device="cpu", timing=True)
    proc.process(payloads("bc1", (100,)))
    assert set(proc.times.seconds) == {"assemble", "h2d", "device", "d2h", "serialize"}
    assert BatchProcessor("bc1", device="cpu").times.seconds == {}
