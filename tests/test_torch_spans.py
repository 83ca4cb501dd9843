"""The port's spans and counters (``utils/profiling.span``, ``backend.counters``) on
the CPU: each batch processor's call is a ``dlt.<prefix>.process`` span holding its
stages' spans, the wait on the device is ``dlt.backend.wait`` inside a ``d2h``
stage, the DDS handler's steps are ``dlt.formats.*`` spans, the zstd-1 scorer is
``dlt.zstd.estimate`` on both routes of the ``optimal`` preset (inside the batch's
``score`` stage, or inside the per-file search's ``dlt.auto.score``), no span opens
a ``record_function`` while no profiler records, and the batch block, zstd and
auto-search counters are exact."""

import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dxt_lossless_transform_tpu_torch import api, backend
from dxt_lossless_transform_tpu_torch.cli.main import make_preset_bundle
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.parallel import (
    BatchProcessor, ModeSortBatchProcessor, RgbBatchProcessor, UntransformBatchProcessor,
)
from dxt_lossless_transform_tpu_torch.utils import testgen
from dxt_lossless_transform_tpu_torch.utils import profiling
from dxt_lossless_transform_tpu_torch.utils.profiling import span

STAGES = {"batch": {"assemble", "h2d", "device", "d2h", "serialize"},
          "untransform": {"assemble", "h2d", "device", "d2h", "serialize"},
          "modesort": {"assemble", "h2d", "device", "d2h", "winners", "guard"},
          "rgb": {"assemble", "h2d", "device", "d2h", "serialize"}}


def traced(fn):
    """``fn()`` under the profiler; -> (its result, [(name, start, end)] of the
    ``dlt.*`` host spans)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("dlt.")]
    return out, spans


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def bc3_results(sizes=(100, 3000)):
    data = [testgen.bc3_realistic(n, seed=n) for n in sizes]
    return data, BatchProcessor("bc3", device="cpu").process(data)


def call_of(kind: str, timing: bool = False):
    """A processor of ``kind`` on the CPU and a call of it on a few seeded payloads."""
    if kind == "batch":
        proc = BatchProcessor("bc3", device="cpu", timing=timing)
        data = [testgen.bc3_realistic(n, seed=n) for n in (100, 3000)]
    elif kind == "untransform":
        proc = UntransformBatchProcessor("bc3", device="cpu", timing=timing)
        data = [(r.transformed, r.settings) for r in bc3_results()[1]]
    elif kind == "modesort":
        proc = ModeSortBatchProcessor("bc7", device="cpu", timing=timing)
        data = [testgen.bc7_realistic(n, seed=n) for n in (64, 100)]
    else:
        proc = RgbBatchProcessor("bgr888", LtuEstimation(), device="cpu", timing=timing)
        data = [testgen.make_uncompressed_dds("bgr888", 8, 8, seed=s)[0x80:]
                for s in (1, 2)]
    return proc, lambda: proc.process(data)


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_a_call_is_one_span_holding_its_stages(kind):
    proc, call = call_of(kind)
    _, spans = traced(call)
    roots = [s for s in spans if s[0] == f"dlt.{kind}.process"]
    assert len(roots) == 1
    stages = [s for s in spans if s[0].startswith(f"dlt.{kind}.") and s not in roots]
    assert {s[0].rsplit(".", 1)[1] for s in stages} == STAGES[kind]
    assert all(inside(s, roots[0]) for s in stages)
    waits = [s for s in spans if s[0] == "dlt.backend.wait"]
    assert len(waits) == proc.batches > 0
    d2h = [s for s in stages if s[0] == f"dlt.{kind}.d2h"]
    assert all(any(inside(w, d) for d in d2h) for w in waits)


def test_the_call_span_counts_calls():
    proc, call = call_of("batch")
    _, spans = traced(lambda: (call(), call()))
    assert [s[0] for s in spans].count("dlt.batch.process") == 2
    assert proc.times.calls == 2


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_timing_keeps_the_same_stage_keys_under_the_profiler(kind):
    proc, call = call_of(kind, timing=True)
    _, spans = traced(call)
    assert set(proc.times.seconds) == STAGES[kind]
    assert {s[0] for s in spans} >= {f"dlt.{kind}.{stage}" for stage in STAGES[kind]}


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_no_record_function_opens_while_no_profiler_records(kind, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(*args, **kwargs):
        opened.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    _, call = call_of(kind)
    call()
    assert opened == []
    assert span("dlt.a") is span("dlt.b", "x=1")
    traced(call)  # the patch sees the spans once a profiler records
    assert f"dlt.{kind}.process" in opened


def test_annotate_is_the_jax_package_name_of_span():
    assert profiling.annotate is span


def test_handler_steps_are_spans_in_both_directions():
    bundle = TransformBundle(bc1=api.Bc1AutoTransformBuilder(LtuEstimation()))
    data = testgen.make_dds("BC1", 32, 32, 3, seed=4)
    handler = DdsHandler("cpu")
    out, spans = traced(lambda: handler.transform_bundle(data, bundle))
    names = [s[0] for s in spans if s[0].startswith("dlt.formats.")]
    assert names == ["dlt.formats.parse", "dlt.formats.transform", "dlt.formats.join"]
    back, spans = traced(lambda: handler.untransform(out))
    assert back == data
    names = [s[0] for s in spans if s[0].startswith("dlt.formats.")]
    assert names == ["dlt.formats.parse", "dlt.formats.untransform", "dlt.formats.join"]


# --- counters -------------------------------------------------------------------------

def blocks() -> tuple:
    c = backend.counters()
    return c["batch.blocks_real"], c["batch.blocks_launched"]


@pytest.mark.parametrize("sizes, real, launched", [
    ((1000, 3000), 4000, 2048 + 4096),
    ((100, 2048, 2049), 4197, 2 * 2048 + 4096),
    ((4096,), 4096, 4096),
])
@pytest.mark.parametrize("fmt", ["bc1", "bc3"])
def test_batch_blocks_are_the_payloads_against_the_padded_rows(fmt, sizes, real,
                                                               launched):
    gen = {"bc1": testgen.bc1_realistic, "bc3": testgen.bc3_realistic}[fmt]
    data = [gen(n, seed=n) for n in sizes] + [b""]
    backend.reset_counters()
    BatchProcessor(fmt, device="cpu").process(data)
    assert blocks() == (real, launched)


def test_batch_blocks_add_up_over_batches_of_max_batch():
    data = [testgen.bc1_realistic(n, seed=n) for n in (100, 200, 300)]
    backend.reset_counters()
    BatchProcessor("bc1", device="cpu", max_batch=2).process(data)
    assert blocks() == (600, 3 * 2048)
    backend.reset_counters()
    assert blocks() == (0, 0)


@pytest.mark.parametrize("kind", ["untransform", "modesort", "rgb"])
def test_the_other_processors_leave_the_batch_counters_alone(kind):
    _, call = call_of(kind)
    backend.reset_counters()
    call()
    assert blocks() == (0, 0)


def test_pool_growths_are_read_from_the_host_allocator(monkeypatch):
    monkeypatch.setattr(torch.cuda, "host_memory_stats",
                        lambda: {"num_host_alloc": 7, "num_host_free": 2})
    assert backend.counters()["pinned_pool_growths"] == 7
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {})
    assert backend.counters()["pinned_pool_growths"] == 0
    assert all(type(v) is int for v in backend.counters().values())


def test_counts_lose_no_increment_across_threads():
    backend.reset_counters()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(5000):
                backend.count("batch.blocks_real", 3)

        workers = [threading.Thread(target=add) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert backend.counters()["batch.blocks_real"] == 16 * 5000 * 3


# --- the zstd-1 scorer of the optimal preset --------------------------------------------

ZSTD_COUNTERS = ("zstd.buffers", "zstd.bytes", "auto.payload_bytes")


def optimal_route(route: str, dds: bytes):
    """One BC3 file through a route of the ``optimal`` preset on the CPU: the
    host-scored batch (its payload) or the per-file DDS handler (the whole file)."""
    if route == "batch":
        proc = BatchProcessor("bc3", estimator=ZstdEstimation(1), device="cpu")
        return lambda: proc.process([dds[0x80:]])
    handler = DdsHandler("cpu")
    return lambda: handler.transform_bundle(dds, make_preset_bundle("optimal"))


@pytest.mark.parametrize("size, mips", [(64, 7), (32, 1)])
@pytest.mark.parametrize("route", ["batch", "file"])
def test_the_zstd_scorer_is_a_span_and_counts_every_region(route, size, mips):
    dds = testgen.make_dds("BC3", size, size, mips, seed=size)
    n = (len(dds) - 0x80) // 16
    backend.reset_counters()
    _, spans = traced(optimal_route(route, dds))
    counts = backend.counters()
    # two alpha sections (2n bytes) and four colour sections (4n bytes), each once
    assert {k: counts[k] for k in ZSTD_COUNTERS} == {
        "zstd.buffers": 6, "zstd.bytes": 2 * 2 * n + 4 * 4 * n,
        "auto.payload_bytes": 16 * n if route == "file" else 0}
    zstd = [s for s in spans if s[0] == "dlt.zstd.estimate"]
    outer = [s for s in spans if s[0] == ("dlt.batch.score" if route == "batch"
                                           else "dlt.auto.score")]
    # each route scores its six regions, alpha and colour rows, in one call
    assert len(zstd) == len(outer) == 1
    assert all(inside(z, o) for z, o in zip(zstd, outer))
    if route == "file":
        transform = [s for s in spans if s[0] == "dlt.formats.transform"]
        assert len(transform) == 1 and all(inside(o, transform[0]) for o in outer)


def test_the_device_scored_search_opens_the_score_span_and_no_zstd_one():
    bundle = TransformBundle(bc3=api.Bc3AutoTransformBuilder(LtuEstimation()))
    data = testgen.make_dds("BC3", 32, 32, 6, seed=5)
    backend.reset_counters()
    _, spans = traced(lambda: DdsHandler("cpu").transform_bundle(data, bundle))
    names = [s[0] for s in spans]
    # one score span a search: the alpha rows' count call, then the colour rows'
    assert names.count("dlt.auto.score") == 1 and "dlt.zstd.estimate" not in names
    counts = backend.counters()
    assert (counts["zstd.buffers"], counts["auto.payload_bytes"]) == (0, len(data) - 0x80)


@pytest.mark.parametrize("buffers", [[], [b"abc"], [b"", bytes(100), b"xy" * 50]])
def test_zstd_counters_take_each_call_whatever_its_size(buffers):
    backend.reset_counters()
    ZstdEstimation(1).estimate_batch(buffers)
    ZstdEstimation(1).estimate_batch(buffers)
    counts = backend.counters()
    assert counts["zstd.buffers"] == 2 * len(buffers)
    assert counts["zstd.bytes"] == 2 * sum(len(b) for b in buffers)


@pytest.mark.parametrize("route", ["batch", "file"])
def test_the_optimal_routes_open_no_record_function_off_the_profiler(route, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counted(*args, **kwargs):
        opened.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    call = optimal_route(route, testgen.make_dds("BC3", 32, 32, 6, seed=2))
    call()
    assert opened == []
    traced(call)
    assert "dlt.zstd.estimate" in opened
