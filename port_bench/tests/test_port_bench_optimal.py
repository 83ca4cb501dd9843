"""The ``bc3-skyrim-mods-optimal.build`` cell on the CPU at a small size: a whole run
on both routes is ``correct``; each fault of an answer is seen by its check; both
controls come out with wrong settings; the reference's zstd-1 binding gives the
program's estimator's sizes; the cell's readers read nothing from empty records."""

import struct
import time

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu_torch.cli import main as cli_main
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from port_bench import run
from port_bench.reference import bc3, zstd1
from port_bench.tests.test_port_bench_run import small

CELL = "bc3-skyrim-mods-optimal.build"
CPU = torch.device("cpu")
# small() keeps chains of 64², 32² and 16²; a 64² chain carries 5,488 payload bytes
LIMIT = 2_000
READERS = ("estimate.optimal_zstd_ms_per_MB", "pipeline.optimal_serialize_ms_per_MB",
           "kernels.optimal_roofline")


@pytest.fixture
def both_routes(monkeypatch):
    monkeypatch.setattr(cli_main, "_BATCH_ZSTD_MAX_BYTES", LIMIT)


def spec():
    return small(run.resolve(run.load_json(run.ROOT / "BENCHMARK.json"), CELL))


def entry():
    return run.load_module(run.bench_dir(run.ROOT) / "entries" / "optimal_transform.py",
                           "optimal_transform_under_test")


@pytest.fixture
def answered(both_routes):
    """A small cell set up on the CPU and one call's answers over its whole pool."""
    s = spec()
    cell = entry().Cell(s["config"], s["mix"], 2 ** 31 + 11, CPU, False)
    cell.make_pool()
    cell.program_setup()
    files = list(range(len(cell.pool)))
    return cell, files, cell.call(files)


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_on_both_routes_is_correct(both_routes, trace):
    res = run.run_cell(spec(), 2 ** 31 + 3, 0.5, trace, CPU, t0=time.perf_counter())
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"] and checks["compared_batch"] > 0 \
        and checks["compared_per_file"] > 0, (checks, res["errors"][:1])
    if trace:
        rec = res["records"]
        # the scorer sees each file's two alpha (2n) and four colour sections (4n)
        assert rec["stage_counters"]["zstd.bytes"] == 1.25 * rec["stage_bytes"]
        assert 0 < rec["stage_batch_bytes"] < rec["stage_bytes"]
        assert {"estimate.optimal_zstd_ms_per_MB",
                "pipeline.optimal_serialize_ms_per_MB"} <= set(res["metrics"])
        assert "kernels.optimal_roofline" not in res["metrics"]  # no card, no kernel


def _alter_byte(answers):
    batch, results, singles = answers
    r = results[0]
    results[0] = type(r)(r.index, bytes([r.transformed[0] ^ 1]) + r.transformed[1:],
                         r.settings)


def _swap_header(answers):
    j, out = answers[2][0]
    word = struct.unpack("<I", out[:4])[0]
    answers[2][0] = (j, struct.pack("<I", word ^ (1 << 9)) + out[4:])  # split alpha


def _drop_half(answers):
    batch, results, singles = answers
    del results[len(results) // 2:]
    del singles[len(singles) // 2:]


@pytest.mark.parametrize("fault, check", [(_alter_byte, "wrong_bytes"),
                                          (_swap_header, "wrong_header"),
                                          (_drop_half, "missing")])
def test_each_fault_is_seen(answered, fault, check):
    cell, files, answers = answered
    assert all(v == 0 for k, (v, _, _) in cell.check([(files, answers)]).items()
               if not k.startswith("compared"))
    answers = (answers[0], list(answers[1]), list(answers[2]))
    fault(answers)
    assert cell.check([(files, answers)])[check][0] > 0


@pytest.mark.parametrize("control", ["skip_search", "ltu_search"])
def test_each_control_ships_wrong_settings(answered, control):
    cell, files, _ = answered
    checks = cell.check([(files, cell.control(control)(files))])
    assert checks["wrong_settings"][0] > 0 and checks["missing"][0] == 0
    assert checks["compared_batch"][0] > 0 and checks["compared_per_file"][0] > 0


def test_an_unknown_control_is_refused(answered):
    with pytest.raises(ValueError):
        answered[0].control("no_search")


def _noise(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()


BUFFERS = {"empty": b"", "one": b"a", "zeros": bytes(4096), "repeats": b"abcd" * 1000,
           "noise": _noise(3000),
           "bc3_sections": bc3.transform(torch.frombuffer(bytearray(_noise(1600)),
                                                          dtype=torch.uint8),
                                         bc3.FAST[0]).numpy().tobytes()}


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_the_reference_zstd1_sizes_are_the_estimators(name):
    buf = BUFFERS[name]
    assert zstd1.size(buf) == ZstdEstimation(1).estimate(buf)


def test_the_dds_header_describes_the_full_chain():
    from dxt_lossless_transform_tpu_torch.formats.dds import DdsFormat, parse_dds
    from port_bench import pool

    e = entry()
    for size in (16, 64, 4096):
        info = parse_dds(e.dds_header(size) + bytes(16 * pool.chain_blocks(size)))
        assert (info.format, info.data_offset, info.data_length) == \
            (DdsFormat.BC3, e.HEADER_SIZE, 16 * pool.chain_blocks(size))


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_from_empty_records(name):
    reader = run.load_module(run.bench_dir(run.ROOT) / "layer_metrics" / f"{name}.py", name)
    assert reader.read({}) is None
    assert reader.read({"stage_span_self_s": {}, "stage_bytes": 10 ** 6,
                        "stage_batch_bytes": 10 ** 6, "kernel_s": 0.0,
                        "bound_s": 1.0}) is None
