"""The ``bc7-skyrim-mods.build`` cell on the CPU at a small size: a whole run, untraced
and traced, is ``correct``; each control, an altered answer and a dropped one come out
not ``correct``; the cell's readers read nothing from empty records and, where the
program lacks their span or counter, from a parent's; the BC7 pool's sizes, kinds and
mode mix are the configuration's; the mode-sort bound is a hand count."""

import json
import time

import pytest
import torch

from port_bench import bounds, bounds_modesort, pool as pool_lib, pool_bc7, run
from port_bench.tests.test_port_bench_run import small

CELL = "bc7-skyrim-mods.build"
CPU = torch.device("cpu")
# the cell's readers: the device's and the kernels' of the BC3 cell, the scorer's of
# the optimal cell, and the mode-sort batch's own
READERS = ("kernels.build_roofline", "device.build_idle",
           "estimate.optimal_zstd_ms_per_MB", "estimate.optimal_zstd_workers",
           "pipeline.modesort_host_ms_per_MB", "pipeline.modesort_useful_blocks")


def spec():
    return small(run.resolve(run.load_json(run.ROOT / "BENCHMARK.json"), CELL))


def run_small(trace=False, control=None, seed=2 ** 31 + 3):
    return run.run_cell(spec(), seed, 0.5, trace, CPU, control=control,
                        t0=time.perf_counter())


def entry():
    return run.load_module(run.bench_dir(run.ROOT) / "entries" / "modesort_transform.py",
                           "modesort_transform_under_test")


def reader(name):
    return run.load_module(run.bench_dir(run.ROOT) / "layer_metrics" / f"{name}.py",
                           f"reader_{name}")


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    res = run_small(trace)
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"] and res["failed"] == 0 and checks["compared"] > 0, \
        (checks, res["errors"][:1])
    assert set(checks) == {"compared", "missing", "wrong_settings", "wrong_bytes",
                           "guarded", "reverted"}
    if not trace:
        assert set(res["metrics"]) == {"build_MBps", "setup_s"}
        return
    rec = res["records"]
    assert {"dlt.modesort.assemble", "dlt.modesort.winners", "dlt.modesort.guard",
            "dlt.zstd.estimate"} <= set(rec["stage_span_self_s"])
    c = rec["stage_counters"]
    assert 0 < c["modesort.blocks_real"] <= c["modesort.blocks_launched"]
    assert c["zstd.worker_us"] > 0
    # no kernel ran: the roofline and the idle share read nothing; the program's
    # spans and counters read
    assert set(res["metrics"]) == set(READERS) - {"kernels.build_roofline",
                                                  "device.build_idle"}


@pytest.mark.parametrize("control", ["skip_search", "skip_guard"])
def test_each_control_comes_out_not_correct(control):
    res = run_small(control=control)
    assert res["correct"] is False
    assert res["checks"]["wrong_settings"]["value"] > 0


@pytest.mark.parametrize("how", ["altered", "half"])
def test_a_broken_answer_comes_out_not_correct(how, monkeypatch):
    from dxt_lossless_transform_tpu_torch.parallel import pipeline

    real = pipeline.ModeSortBatchProcessor.process

    def process(self, payloads):
        out = real(self, payloads)
        if how == "half":
            return out[: len(out) // 2]
        r = out[len(out) // 2]
        out[len(out) // 2] = pipeline.BatchResult(
            r.index, bytes([r.transformed[0] ^ 1]) + r.transformed[1:], r.settings)
        return out
    monkeypatch.setattr(pipeline.ModeSortBatchProcessor, "process", process)
    res = run_small()
    assert res["correct"] is False
    bad = {"altered": "wrong_bytes", "half": "missing"}[how]
    assert res["checks"][bad]["value"] > 0


def test_an_unknown_control_is_refused():
    s = spec()
    cell = entry().Cell(s["config"], s["mix"], 1, CPU, False)
    with pytest.raises(ValueError):
        cell.control("no_such")


def test_the_cell_lists_its_readers():
    assert [m["name"] for m in spec()["per_layer"]] == list(READERS)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_from_empty_records(name):
    assert reader(name).read({}) is None


PARENT = {"stage_span_self_s": {"dlt.modesort.assemble": 0.1, "dlt.modesort.guard": 0.01,
                                "dlt.zstd.estimate": 0.5},
          "stage_counters": {"batch.blocks_real": 0, "zstd.worker_us": 2 * 10 ** 6},
          "stage_bytes": 10 ** 9, "kernel_s": 2.0, "bound_s": 1.0,
          "busy_s": 1.0, "window_s": 4.0, "device_events": 7}


@pytest.mark.parametrize("name, want", [
    ("kernels.build_roofline", 50.0), ("device.build_idle", 75.0),
    ("estimate.optimal_zstd_ms_per_MB", 0.5), ("estimate.optimal_zstd_workers", 4.0),
    ("pipeline.modesort_host_ms_per_MB", None), ("pipeline.modesort_useful_blocks", None),
])
def test_a_parent_without_the_winners_span_and_the_counters_reads_none_there(name, want):
    got = reader(name).read(PARENT)
    assert got == pytest.approx(want) if want is not None else got is None


def test_the_readers_on_the_programs_records():
    rec = dict(PARENT, stage_span_self_s={"dlt.modesort.assemble": 0.1,
                                          "dlt.modesort.winners": 0.2},
               stage_counters={"modesort.blocks_real": 2, "modesort.blocks_launched": 3})
    assert reader("pipeline.modesort_host_ms_per_MB").read(rec) == pytest.approx(0.3)
    assert reader("pipeline.modesort_useful_blocks").read(rec) == pytest.approx(200 / 3)


def config():
    return json.loads((run.ROOT / "port_bench" / "configs" / "bc7-skyrim-mods.json")
                      .read_text())


def test_the_pool_keeps_the_bc3_corpus_sizes_and_deals_the_kinds():
    cfg = config()
    total = sum(c * 16 * pool_lib.chain_blocks(s) for s, c in cfg["sizes"])
    assert sum(c for _, c in cfg["sizes"]) == cfg["files"] == 112
    assert total == 528_834_816
    shares = [cfg["kinds"][k] for k in pool_bc7.KINDS]
    rows = pool_bc7.deal(cfg["sizes"], shares)
    assert [sum(r) for r in rows] == [c for _, c in sorted(cfg["sizes"], reverse=True)]
    counts = [sum(r[k] for r in rows) for k in range(len(shares))]
    assert counts == pool_lib.apportion(112, shares) == [24, 42, 8, 34, 4]
    # the study's shipped shares: identity 59% (picked and reverted), sort+planes 30%,
    # sort 7%, planes 4%; the identity split 25 : 45 as the medium preset splits it
    assert cfg["kinds"]["identity"] + cfg["kinds"]["reverted"] == pytest.approx(0.59)
    assert cfg["kinds"]["identity"] / cfg["kinds"]["reverted"] == \
        pytest.approx(25 / 45, rel=1e-5)


def test_a_pool_holds_its_kinds_and_the_mode_mix():
    cfg = dict(config(), sizes=[[256, 9], [128, 48], [64, 38], [32, 17]])
    files = pool_bc7.make_pool(cfg, 2 ** 32 + 9, CPU)
    kinds = [f.kind for f in files]
    assert [kinds.count(k) for k in pool_bc7.KINDS] == [24, 42, 8, 34, 4]
    again = pool_bc7.make_pool(cfg, 2 ** 32 + 9, CPU)
    assert [f.payload for f in again] == [f.payload for f in files]
    ids = torch.cat([bc7_modes(f.payload) for f in files])
    share = {m: 100.0 * float((ids == m).sum()) / ids.numel() for m in range(9)}
    for m, want in cfg["modes"].items():
        assert share[int(m)] == pytest.approx(want / sum(cfg["modes"].values()) * 100,
                                              abs=1.5), m
    assert share[0] == share[2] == share[8] == 0.0


def bc7_modes(payload: bytes) -> torch.Tensor:
    from port_bench.reference import bc7

    return bc7.modes(torch.frombuffer(bytearray(payload), dtype=torch.uint8))


def test_the_bound_is_a_hand_count_on_a_two_file_batch():
    """Two files of zero blocks (mode id 8) of n = 4 and n = 1. An unsorted row is
    zeros: each position past the first matches one byte back at one compare. A
    sorted row leads with its mode stream (0x88 0x88 for n = 4, 0x08 for n = 1): its
    first zero gram misses at offsets 1 and 2 (n = 4) or 1 (n = 1), then each matches
    at one compare. The zero rows score least, the identity first."""
    s = spec()
    cell = entry().Cell(s["config"], s["mix"], 1, CPU, True)
    cell.pool = [pool_lib.PoolFile(0, n, "hand", bytes(16 * n),
                                   {"device": torch.zeros(16 * n, dtype=torch.uint8)})
                 for n in (4, 1)]
    cell.reference_setup()
    # (row length, compares) of identity, sort, planes, sort+planes
    rows4 = [(64, 60), (66, 63), (64, 60), (66, 63)]
    rows1 = [(16, 12), (17, 13), (16, 12), (17, 13)]
    want = 0.0
    for n, rows in ((4, rows4), (1, rows1)):
        nbytes = 4 * 16 * n + 2 * sum(r for r, _ in rows) + 2 * 16 * n  # gather: identity
        ops = 2 * sum(r - 3 for r, _ in rows) + 2 * sum(c for _, c in rows)
        assert bounds_modesort.file_bytes(n, [False, True, False, True], False) == nbytes
        assert bounds_modesort.file_ops(n, [False, True, False, True],
                                        sum(c for _, c in rows)) == ops
        want += bounds.bytes_seconds(nbytes) + bounds.ops_seconds(ops)
    assert cell.bound_seconds([0, 1]) == pytest.approx(want, rel=1e-12)
