"""``spans.py``: self seconds of nested program spans, the counters' change and the
figures read from them, on hand-made events; then one small traced run of each cell
on the CPU through :func:`spans.traced_run`."""

import pytest
import torch

from port_bench import run, spans, trace
from port_bench.tests.test_port_bench_run import CELLS, small
from port_bench.trace import Event

NS = 1_000_000_000


def window(*events):
    return [Event(trace.WINDOW, "window", 0, 100 * NS), *events]


NESTED = window(
    Event("dlt.batch.process", "host", 10 * NS, 60 * NS),
    Event("dlt.batch.assemble", "host", 10 * NS, 20 * NS),   # starts with its parent
    Event("aten::copy_", "host", 12 * NS, 14 * NS),          # not a program span
    Event("dlt.batch.d2h", "host", 30 * NS, 40 * NS),
    Event("dlt.backend.wait", "host", 31 * NS, 35 * NS),
    Event("dlt.batch.serialize", "host", 40 * NS, 58 * NS),
    Event("dlt.batch.process", "host", 70 * NS, 90 * NS),
    Event("dlt.batch.serialize", "host", 75 * NS, 85 * NS),
    Event("dlt.batch.process", "host", 95 * NS, 120 * NS),   # cut at the window
    Event("dlt.batch.process", "host", 120 * NS, 130 * NS),  # after it
    Event("port_bench.call", "host", 5 * NS, 95 * NS),
    Event("k", "kernel", 20 * NS, 30 * NS),
    Event("Memcpy DtoH (Device -> Pinned)", "memcpy", 32 * NS, 36 * NS),
)


def test_self_seconds_take_out_the_program_spans_directly_inside():
    got = spans.self_seconds(NESTED)
    assert got == pytest.approx({
        "dlt.batch.process": (50 - 10 - 10 - 18) + (20 - 10) + 5,
        "dlt.batch.assemble": 10, "dlt.batch.d2h": 10 - 4, "dlt.backend.wait": 4,
        "dlt.batch.serialize": 18 + 10})


def test_no_window_raises():
    with pytest.raises(ValueError):
        spans.self_seconds([Event("dlt.batch.process", "host", 0, 1)])


def test_reduce_takes_the_counters_change():
    before = {"batch.blocks_real": 10, "batch.blocks_launched": 12,
              "pinned_pool_growths": 3}
    after = {"batch.blocks_real": 30, "batch.blocks_launched": 42,
             "pinned_pool_growths": 5}
    rec = spans.reduce(NESTED, before, after)
    assert rec["counters"] == {"batch.blocks_real": 20, "batch.blocks_launched": 30,
                               "pinned_pool_growths": 2}
    assert rec["span_self_s"] == spans.self_seconds(NESTED)


def records():
    return {"bytes": 2_000_000_000,
            "span_self_s": {"dlt.batch.serialize": 1.5, "dlt.batch.assemble": 0.5,
                            "dlt.backend.wait": 0.02},
            "counters": {"batch.blocks_real": 4000, "batch.blocks_launched": 6144,
                         "pinned_pool_growths": 3}}


def test_quantities_per_mb_and_per_gb():
    q = spans.quantities(records())
    assert q == pytest.approx({
        "build_serialize_ms_per_MB": 1500 / 2000, "build_assemble_ms_per_MB": 500 / 2000,
        "build_wait_ms_per_MB": 20 / 2000, "build_useful_blocks": 100 * 4000 / 6144,
        "build_pinned_growths_per_GB": 1.5})


@pytest.mark.parametrize("missing", ["bytes", "span_self_s", "counters"])
def test_a_figure_whose_inputs_are_missing_is_none(missing):
    rec = records()
    del rec[missing]
    q = spans.quantities(rec)
    none = {"bytes": {"build_serialize_ms_per_MB", "build_assemble_ms_per_MB",
                      "build_wait_ms_per_MB", "build_pinned_growths_per_GB"},
            "span_self_s": {"build_serialize_ms_per_MB", "build_assemble_ms_per_MB",
                            "build_wait_ms_per_MB"},
            "counters": {"build_useful_blocks", "build_pinned_growths_per_GB"}}[missing]
    assert {k for k, v in q.items() if v is None} == none


def test_a_program_without_spans_or_counters_reads_none():
    q = spans.quantities({"bytes": 10 ** 9, "span_self_s": {}, "counters": {}})
    assert set(q.values()) == {None}


@pytest.mark.parametrize("name", CELLS)
def test_a_small_traced_run_on_the_cpu_has_the_records(name):
    spec = small(run.resolve(run.load_json(run.ROOT / "BENCHMARK.json"), name))
    plain = trace.profile
    res, rec = spans.traced_run(spec, 2 ** 31 + 7, 0.5, torch.device("cpu"))
    assert trace.profile is plain
    assert res["correct"] and rec["bytes"] == res["window"]["bytes"] > 0
    assert {"dlt.batch.process", "dlt.batch.assemble", "dlt.batch.serialize",
            "dlt.backend.wait"} <= set(rec["span_self_s"])
    assert all(v >= 0 for v in rec["span_self_s"].values())
    q = spans.quantities(rec)
    assert 0 < q["build_useful_blocks"] <= 100
    c = rec["counters"]
    assert c["batch.blocks_real"] <= c["batch.blocks_launched"]
    assert c["pinned_pool_growths"] == 0  # no card
