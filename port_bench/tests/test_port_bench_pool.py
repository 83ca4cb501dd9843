import json

import pytest
import torch

from port_bench import pool, stream
from port_bench.run import ROOT

CPU = torch.device("cpu")
SMALL = {"format": "bc1", "sizes": [[64, 5], [16, 3]],
         "kinds": {"correlated": 0.711, "tight": 0.179, "independent": 0.110}}


def config(name):
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, files, payload_bytes, mean_mb", [
    ("bc1-skyrim-mods", 128, 551_377_920, 4.31),
    ("bc3-skyrim-mods", 112, 528_834_816, 4.72),
])
def test_pool_sizes_keep_the_corpus_mean(name, files, payload_bytes, mean_mb):
    cfg = config(name)
    bs = pool.BLOCK_SIZE[cfg["format"]]
    counts = [c for _, c in cfg["sizes"]]
    total = sum(c * bs * pool.chain_blocks(s) for s, c in cfg["sizes"])
    assert sum(counts) == files == cfg["files"]
    assert total == payload_bytes
    # whole files: each payload behind its 128-byte legacy DDS header
    assert (total + 128 * files) / files / 1e6 == pytest.approx(mean_mb, abs=0.005)


def test_chain_blocks():
    assert pool.chain_blocks(4096) == 1_398_103
    assert pool.chain_blocks(512) == 21_847
    assert pool.chain_blocks(1) == 1 and pool.chain_blocks(8) == 4 + 1 + 1 + 1


def test_apportion_keeps_totals_and_shares():
    assert pool.apportion(37, [0.711, 0.179, 0.110]) == [26, 7, 4]
    assert pool.apportion(128, [0.711, 0.179, 0.110]) == [91, 23, 14]
    assert sum(pool.apportion(7, [1, 1, 1])) == 7
    assert pool.apportion(7, [1, 1, 1]) == [3, 2, 2]


def test_the_same_seed_gives_the_same_pool_and_another_seed_another_order():
    a = pool.make_pool(SMALL, 2 ** 31 + 17, CPU)
    b = pool.make_pool(SMALL, 2 ** 31 + 17, CPU)
    c = pool.make_pool(SMALL, 5, CPU)
    assert [f.payload for f in a] == [f.payload for f in b]
    assert [f.payload for f in a] != [f.payload for f in c]
    # every seed does the same work: the same sizes and kinds, in another order
    assert sorted((f.size, f.kind) for f in a) == sorted((f.size, f.kind) for f in c)
    for f in a:
        assert len(f.payload) == 8 * pool.chain_blocks(f.size)


def test_bc3_blocks_hold_bc1_colour_halves_and_opaque_alpha():
    cfg = dict(SMALL, format="bc3")
    files = pool.make_pool(cfg, 3, CPU)
    for f in files:
        blocks = torch.frombuffer(bytearray(f.payload), dtype=torch.uint8).view(-1, 16)
        assert blocks.shape[0] == pool.chain_blocks(f.size)
        assert blocks[:, 0].float().mean() > 150  # alpha0 near 200
        assert bool((blocks[:, 1] <= blocks[:, 0]).all())


def test_stream_cuts_passes_by_bytes_and_by_files():
    sizes = [10, 20, 30, 40]
    calls = stream.calls(sizes, {"cut": {"bytes": 50}}, 9)
    first = [next(calls) for _ in range(6)]
    flat = [i for c in first for i in c]
    assert sorted(flat[:4]) == [0, 1, 2, 3]  # a pass holds every file once
    for c in first:
        assert sum(sizes[i] for i in c) >= 50
        assert sum(sizes[i] for i in c[:-1]) < 50
    one = stream.calls(sizes, {"cut": {"files": 1}}, 9)
    assert [next(one) for _ in range(4)] == [[i] for i in flat[:4]]


def test_keeper_draws_from_the_seed_and_stops_at_its_bytes():
    mix = {"check_share": 0.5, "check_bytes": 30}
    k1, k2 = stream.keeper(mix, 4), stream.keeper(mix, 4)
    d1 = [k1(10) for _ in range(20)]
    assert d1 == [k2(10) for _ in range(20)]
    assert d1[0] and sum(d1) == 3  # the first call, then seeded draws
