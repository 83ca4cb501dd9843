"""The reader of ``estimate.optimal_zstd_workers``: it needs both the scorer's worker
counter and its span, reads their ratio, and shows up in a small traced run of the
``bc3-skyrim-mods-optimal.build`` cell on the CPU."""

import time

import pytest

from port_bench import run
from port_bench.tests.test_port_bench_optimal import CPU, both_routes, spec  # noqa: F401

NAME = "estimate.optimal_zstd_workers"


def _reader():
    return run.load_module(run.bench_dir(run.ROOT) / "layer_metrics" / f"{NAME}.py", NAME)


@pytest.mark.parametrize("records, want", [
    # a program without the worker counter
    ({"stage_counters": {"zstd.bytes": 10}, "stage_span_self_s": {"dlt.zstd.estimate": 2.0}},
     None),
    # no scorer span in the stage pass
    ({"stage_counters": {"zstd.worker_us": 6_000_000}, "stage_span_self_s": {}}, None),
    ({"stage_counters": {"zstd.worker_us": 6_000_000},
      "stage_span_self_s": {"dlt.zstd.estimate": 0.0}}, None),
    # empty records
    ({"stage_span_self_s": {}, "stage_bytes": 10 ** 6, "stage_batch_bytes": 10 ** 6,
      "kernel_s": 0.0, "bound_s": 1.0}, None),
    # 6 worker-seconds in 1.5 s of the open span: 4 workers on average
    ({"stage_counters": {"zstd.worker_us": 6_000_000},
      "stage_span_self_s": {"dlt.zstd.estimate": 1.5}}, 4.0),
])
def test_the_workers_reader_needs_the_counter_and_the_span(records, want):
    assert _reader().read(records) == want


def test_a_small_traced_run_reports_the_workers(both_routes):  # noqa: F811
    res = run.run_cell(spec(), 2 ** 31 + 5, 0.5, True, CPU, t0=time.perf_counter())
    assert res["correct"], res["errors"][:1]
    assert 0 < res["metrics"][NAME]["value"]
