"""The plain reference against hand cases, and against the port on the CPU."""

import pytest
import torch

from port_bench import pool
from port_bench.reference import bc1, bc3, common

CPU = torch.device("cpu")


def t(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_ycocg_round_trips_every_colour(variant):
    c = torch.arange(65536, dtype=torch.int64)
    d = common.decorrelate(c, variant)
    assert int(d.min()) >= 0 and int(d.max()) < 65536
    assert torch.equal(common.recorrelate(d, variant), c)
    if variant:
        assert len(torch.unique(d)) == 65536


def test_ycocg_hand_case():
    # pure red 0xF800: r=31, g=0, b=0 -> co=31, t=15, cg=17, y=23 (5-bit wraps)
    assert int(common.decorrelate(torch.tensor([0xF800]), 1)) == \
        (23 << 11) | (31 << 6) | 17


def test_ltu_score_hand_cases():
    # eight equal bytes: positions 0..4 counted; 1..4 match at offset 1 (weight 24)
    assert common.weight(1) == 24 and common.weight(3) == 22 and common.weight(4096) == 12
    row = torch.full((8,), 7, dtype=torch.uint8)
    g = common.g_table()
    ent = 3 * max(0, int(g[8]) - int(g[8])) // 8
    assert common.ltu_score(row, 8) == 24 * 8 - 4 * 24 + ent
    # no repeat at all: no coverage; four of the five positions look at 1..i offsets
    row = torch.arange(8, dtype=torch.uint8)
    assert common.ltu_score(row, 8) == 24 * 8 + 3 * (int(g[8]) - 8 * int(g[1])) // 8
    w, comp = common.nearest_match(row, 8)
    assert w.tolist() == [0] * 5 and comp.tolist() == [0, 1, 2, 3, 4]
    # a period of 3: positions 3 and 4 match at offset 3, found at the third compare
    row = torch.tensor([1, 2, 3] * 3, dtype=torch.uint8)
    w, comp = common.nearest_match(row, 9)
    assert w.tolist() == [0, 0, 0, 22, 22, 22] and comp.tolist() == [0, 1, 2, 3, 3, 3]


@pytest.mark.parametrize("ref", [bc1, bc3])
def test_round_trip_and_headers(ref):
    data = pool.make_pool({"format": ref.__name__.rsplit(".", 1)[1], "sizes": [[32, 2]],
                           "kinds": {"correlated": 1, "tight": 1, "independent": 1}},
                          1, CPU)
    for f in data:
        x = t(f.payload)
        for s in ref.ALL:
            y = ref.transform(x, s)
            assert y.numel() == x.numel()
            assert torch.equal(ref.untransform(y, s), x)
            assert ref.settings_of(ref.header(s)) == s


def test_identical_blocks_tie_and_the_first_candidate_wins():
    block = bytes([0x1F, 0xF8, 0xE0, 0x07, 0x55, 0xAA, 0x55, 0xAA])
    x = t(block * 64)
    best, scores = bc1.search(x)
    assert best == scores.index(min(scores))
    # no decorrelation and no split give the block's own colour word: the
    # colour section repeats with period 4, as the untouched payload's colours do
    assert bc1.colour_section(x, bc1.FAST[0]).tolist() == list(block[:4]) * 64


def test_bc3_sums_alpha_and_colour_sections():
    data = pool.make_pool({"format": "bc3", "sizes": [[16, 1]],
                           "kinds": {"correlated": 1, "tight": 0, "independent": 0}},
                          2, CPU)[0]
    x = t(data.payload)
    n = x.numel() // 16
    _, scores = bc3.search(x)
    for s, score in zip(bc3.FAST, scores):
        assert score == (common.ltu_score(bc3.alpha_section(x, s), 2 * n)
                         + common.ltu_score(bc3.colour_section(x, s), 4 * n))
    assert len(bc3.sections(x)) == 6


@pytest.mark.parametrize("fmt", ["bc1", "bc3"])
def test_reference_agrees_with_the_port_on_the_cpu(fmt):
    """The port's batch pipeline, its transforms and its scorer on the CPU pick and
    produce what the reference does (the benchmark's check on the card holds the
    same comparison at full size)."""
    from dxt_lossless_transform_tpu_torch.estimate.ltu import coverage_scores
    from dxt_lossless_transform_tpu_torch.parallel.pipeline import BatchProcessor

    ref = {"bc1": bc1, "bc3": bc3}[fmt]
    files = pool.make_pool({"format": fmt, "sizes": [[128, 3], [64, 3]],
                            "kinds": {"correlated": 1, "tight": 1, "independent": 1}},
                           21, CPU)
    results = BatchProcessor(fmt, device="cpu").process([f.payload for f in files])
    picks = set()
    for f, r in zip(files, results):
        x = t(f.payload)
        best, _ = ref.search(x)
        want = ref.FAST[best]
        picks.add(best)
        assert {k: type(v)(getattr(r.settings, k)) for k, v in want.items()} == want
        assert r.transformed == ref.transform(x, want).numpy().tobytes()
        for row, valid in ref.sections(x):
            port = int(coverage_scores(row[None, :], valid)[0])
            assert port == common.ltu_score(row, valid)
    assert len(picks) == 3  # each kind of file has its own winner
