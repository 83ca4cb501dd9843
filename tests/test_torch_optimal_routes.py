"""The benchmark's ``optimal`` build entry (``port_bench/entries/optimal_transform.py``)
on the CPU: one call over a small pool of BC3 full chains (64² to 256²), with the
batch limit lowered so that the 256² chains take the per-file DDS route and the rest
the host-scored batch, as the CLI's ``_batchable`` routes them. Every answer of each
route is held to the plain zstd-1 reference (``port_bench/reference/bc3_zstd.py``):
its settings, its payload bytes and, per file, its header."""

import importlib
import struct

import pytest
import torch

from dxt_lossless_transform_tpu_torch.cli import main as cli_main

entry = importlib.import_module("port_bench.entries.optimal_transform")
bc3 = importlib.import_module("port_bench.reference.bc3")
bc3_zstd = importlib.import_module("port_bench.reference.bc3_zstd")

CONFIG = {"format": "bc3", "preset": "optimal",
          "sizes": [[256, 2], [128, 3], [64, 3]],
          "kinds": {"correlated": 0.711, "tight": 0.179, "independent": 0.11}}
MIX = {"max_batch": 2, "warmup_calls": 0}
# a 256² chain carries 87,408 payload bytes, a 128² chain 21,872
LIMIT = 50_000


@pytest.fixture(scope="module")
def answered():
    """The cell's pool and one call's answers over all of it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_main, "_BATCH_ZSTD_MAX_BYTES", LIMIT)
        cell = entry.Cell(CONFIG, MIX, 2 ** 33 + 5, torch.device("cpu"), False)
        cell.make_pool()
        cell.program_setup()
        files = list(range(len(cell.pool)))
        return cell, files, cell.call(files)


def expected(cell, i):
    x = torch.frombuffer(bytearray(cell.pool[i].payload), dtype=torch.uint8)
    want = bc3.FAST[bc3_zstd.search(x)[0]]
    return want, bc3.transform(x, want).numpy().tobytes()


def test_each_file_takes_the_route_the_cli_gives_it(answered):
    cell, files, (batch, results, singles) = answered
    big = {i for i in files if cell.sizes[i] > LIMIT}
    assert len(big) == 2 and {files[j] for j, _ in singles} == big
    assert {files[j] for j in batch} == set(files) - big
    assert len(results) == len(batch)


@pytest.mark.parametrize("route", ["batch", "file"])
def test_every_answer_of_a_route_is_the_reference_search_and_transform(answered, route):
    cell, files, (batch, results, singles) = answered
    if route == "batch":
        for r in results:
            i = files[batch[r.index]]
            want, data = expected(cell, i)
            assert {k: int(getattr(r.settings, k)) for k in want} == \
                {k: int(v) for k, v in want.items()}
            assert r.transformed == data
        return
    for j, out in singles:
        i = files[j]
        want, data = expected(cell, i)
        blob = cell.blobs[i]
        assert struct.unpack("<I", out[:4])[0] == bc3.header(want)
        assert out[4:entry.HEADER_SIZE] == blob[4:entry.HEADER_SIZE]
        assert out[entry.HEADER_SIZE:] == data and len(out) == len(blob)


def test_the_check_finds_the_call_correct(answered):
    cell, files, answers = answered
    checks = cell.check([(files, answers)])
    assert checks["compared"][0] == len(files)
    assert checks["compared_batch"][0] > 0 and checks["compared_per_file"][0] > 0
    assert all(v == 0 for k, (v, _, _) in checks.items() if not k.startswith("compared"))
