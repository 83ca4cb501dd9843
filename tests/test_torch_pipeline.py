"""The port's corpus batch pipeline, device-scored (``parallel/pipeline.py``
``BatchProcessor`` under LTU, ``parallel/sharded.py``; plain versions on the CPU),
against the JAX package's ``BatchProcessor(fmt, mesh=None)``.
Payloads come from the generators with numpy seeds, at the JAX package's own batch
test sizes (``tests/test_parallel.py``): 64, 100, 2048, 2049, 3000 and 5000 blocks
(ragged files in three buckets), ``max_batch`` below the file count, one empty
payload. Settings and bytes must be equal (exact). Candidate lists longer than the
rows kernel's 16, with repeats, are held to JAX under both estimators, on one device
and under a mesh. The batch's host copies (``parallel/host_copy.py``), on a pool and on
the calling thread, are held to the per-file search, to the mesh's repeated rows, to
their counters, and to results that outlive the next call's staging."""

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
from dxt_lossless_transform_tpu_torch.parallel import host_copy, pipeline

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


# --- the host copier's two calls a batch (``parallel/host_copy.py``) --------------------

COPY_SIZES = (64, 100, 700, 2049)


@pytest.fixture(scope="module")
def four():
    pool = host_copy.CopyPool(4)
    yield pool
    pool.close()


@pytest.fixture
def copies_on(monkeypatch, four):
    """Every copy on a pool of four threads, or every copy on the calling thread."""
    def on(copies: str) -> None:
        monkeypatch.setattr(host_copy, "_pool", four)
        monkeypatch.setattr(host_copy, "SERIAL_BYTES",
                            0 if copies == "parallel" else 1 << 40)
    return on


def estimator_of(scorer: str):
    return LtuEstimation() if scorer == "ltu" else ZstdEstimation(1)


@pytest.mark.parametrize("copies", ["parallel", "serial"])
@pytest.mark.parametrize("scorer", ["ltu", "zstd1"])
@pytest.mark.parametrize("fmt", list(BLOCK_SIZE))
def test_the_copier_gives_the_per_file_search(fmt, scorer, copies, copies_on):
    """Batches above and below the copier's serial threshold: each result is a
    ``bytes``, the per-file search's settings and bytes (BC5 under LTU sums its two
    endpoint rows' scores, so its bytes are held to the per-file transform under the
    batch's pick), and the copier's counters add up to the batch's staged rows and
    its results."""
    copies_on(copies)
    data = payloads(fmt, COPY_SIZES)
    est = estimator_of(scorer)
    backend.reset_counters()
    got = BatchProcessor(fmt, max_batch=2, estimator=est, device="cpu").process(data)
    assert [r.index for r in got] == list(range(len(data)))
    for r, payload in zip(got, data):
        assert type(r.transformed) is bytes
        if not payload:
            assert r.transformed == b""
        elif fmt == "bc5" and scorer == "ltu":
            assert PER_FILE[fmt](payload, est, candidates=[r.settings],
                                 device="cpu") == (r.transformed, r.settings)
        else:
            assert PER_FILE[fmt](payload, est, device="cpu") == (r.transformed,
                                                                r.settings)
    c = backend.counters()
    staged = c["batch.blocks_launched"] * BLOCK_SIZE[fmt]
    moved = {"parallel": c["batch.copy_bytes_parallel"],
             "serial": c["batch.copy_bytes_serial"]}
    assert moved.pop(copies) == staged + sum(map(len, data))
    assert moved.popitem()[1] == 0
    assert c["batch.copy_threads"] == (4 if copies == "parallel" else 0)


@pytest.mark.parametrize("scorer", ["ltu", "zstd1"])
def test_a_mesh_batch_repeats_its_last_file_in_the_padding_rows(scorer, copies_on,
                                                                monkeypatch):
    """On a 3x2 mesh a batch of 2 files is padded to 3 rows: the copier lays the last
    file into the third row as well, every row's tail zeroed; the results are the
    one-device processor's."""
    copies_on("parallel")
    data = payloads("bc3", (64, 700, 2049))
    mesh = make_mesh(devices=[torch.device("cpu")] * 6)
    proc = BatchProcessor("bc3", mesh=mesh, max_batch=2, estimator=estimator_of(scorer),
                          device="cpu")
    staged = []
    launch = proc._launch

    def keep(flats, valid):
        staged.append((flats.numpy().view(np.uint8).copy(), list(valid)))
        return launch(flats, valid)

    monkeypatch.setattr(proc, "_launch", keep)
    got = proc.process(data)
    live = [p for p in data if p]  # in one bucket each but the first two
    assert [len(s[0]) for s in staged] == [3, 3]
    laid = [[live[0], live[1], live[1]], [live[2]] * 3]
    for (host, valid), files in zip(staged, laid):
        for row, payload in zip(host, files):
            assert row.tobytes() == payload + bytes(row.size - len(payload))
        assert valid == [len(p) // 4 for p in files]
    want = BatchProcessor("bc3", max_batch=2, estimator=estimator_of(scorer),
                          device="cpu").process(data)
    assert [(r.transformed, r.settings) for r in got] == \
        [(r.transformed, r.settings) for r in want]


@pytest.mark.parametrize("fmt", list(BLOCK_SIZE))
def test_results_outlive_the_staging_that_a_second_call_reuses(fmt, copies_on):
    """Each ``transformed`` is a ``bytes`` of its own: a second call, which takes the
    staging buffers again, leaves the first call's results as they were."""
    copies_on("parallel")
    proc = BatchProcessor(fmt, max_batch=2, device="cpu")
    first = proc.process(payloads(fmt, COPY_SIZES))
    kept = [bytearray(r.transformed) for r in first]
    second = proc.process(payloads(fmt, (2049, 700, 100, 64)))
    assert all(type(r.transformed) is bytes for r in first + second)
    assert [bytearray(r.transformed) for r in first] == kept
    assert not any(r.transformed is s.transformed for r in first for s in second
                   if r.transformed)
