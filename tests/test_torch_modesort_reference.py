"""The BC7 mode-sort batch of the ``medium`` preset against the benchmark's plain BC7
reference (``port_bench/reference/bc7.py``) on the CPU.

The reference's transform equals the JAX package's numpy oracle and the port's plain
version byte for byte, for every setting, on byte-0 mixes that hold invalid blocks,
across the oracle's 4096-block sort chunk. Its search and guard equal
``ModeSortBatchProcessor(device="cpu")`` on a seeded batch of mixed sizes drawn by the
benchmark's BC7 pool (``port_bench/pool_bc7.py``), in which every candidate ships and
the guard turns an LTU pick back to the identity. The processor's two host copies on
the parallel copier give the bytes of the one-thread numpy copies they replace, on
the calling thread and on the pool (a batch over ``host_copy.SERIAL_BYTES``); its
counters and its ``winners`` stage are exact."""

import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dxt_lossless_transform_tpu.oracle import bc7 as obc7
from dxt_lossless_transform_tpu.settings import Bc7TransformSettings as J7
from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.ops import lanes
from dxt_lossless_transform_tpu_torch.ops.cuda import planes
from dxt_lossless_transform_tpu_torch.parallel import ModeSortBatchProcessor, host_copy

ref = importlib.import_module("port_bench.reference.bc7")
pool_bc7 = importlib.import_module("port_bench.pool_bc7")

CPU = torch.device("cpu")
MODES = {"1": 29.8, "3": 26.9, "4": 12.5, "5": 11.6, "6": 16.4, "7": 2.9}
# one file of each kind at 512², where each kind ships its setting, and three 64²
POOL = {"sizes": [[512, 5], [64, 3]], "kinds": dict.fromkeys(pool_bc7.KINDS, 1),
        "modes": MODES}
MAX_BATCH = 3


def byte0_mix(n: int, mix: str, seed: int) -> bytes:
    """n random blocks whose byte 0 is any value (``every``) or, with even odds, 0,
    the invalid block (``invalid``)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (n, 16), np.uint8)
    if mix == "invalid":
        b[:, 0] = np.where(rng.random(n) < 0.5, 0, 1 << rng.integers(0, 8, n))
    return b.tobytes()


def tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


@pytest.mark.parametrize("mix", ["every", "invalid"])
@pytest.mark.parametrize("setting", ref.FAST, ids=lambda s: f"sort{int(s['sort_by_mode'])}"
                         f"planes{int(s['split_byte_planes'])}")
@pytest.mark.parametrize("n", [1, 2, 3, 4097])
def test_reference_transform_is_the_oracle_and_the_port(n, setting, mix):
    data = byte0_mix(n, mix, seed=n)
    got = ref.transform(tensor(data), setting).numpy().tobytes()
    want = obc7.transform(data, J7(setting["sort_by_mode"], setting["split_byte_planes"]))
    port = planes.bc7_transform_plain(tensor(data), planes.BC7, setting["sort_by_mode"],
                                      setting["split_byte_planes"]).numpy().tobytes()
    assert got == want == port
    assert ref.untransform(tensor(got), setting).numpy().tobytes() == data


def test_reference_modes_are_the_oracles_for_every_byte0():
    blocks = np.zeros((256, 16), np.uint8)
    blocks[:, 0] = np.arange(256)
    data = blocks.tobytes()
    assert ref.modes(tensor(data)).tolist() == obc7.block_modes(data).tolist()
    assert ref.modes(tensor(data))[0] == ref.INVALID_MODE == 8


def test_reference_sort_is_local_to_each_chunk():
    n = ref.SORT_CHUNK_BLOCKS + 2
    ids = torch.full((n,), 7)
    ids[ref.SORT_CHUNK_BLOCKS:] = 1  # the ragged chunk sorts before the first if global
    assert torch.equal(ref.sort_order(ids), torch.arange(n))
    ids[1] = 0
    assert ref.sort_order(ids)[:2].tolist() == [1, 0]


@pytest.fixture(scope="module")
def batch():
    """The pool, the reference's (pick, shipped index) of each file, and one
    processor call over every file, its counters' change and its picks."""
    pool = pool_bc7.make_pool(POOL, 2 ** 33 + 1, CPU)
    want = [ref.shipped(tensor(f.payload)) for f in pool]
    payloads = [f.payload for f in pool]
    proc = ModeSortBatchProcessor("bc7", max_batch=MAX_BATCH, device="cpu")
    before = backend.counters()
    got = proc.process(payloads)
    after = backend.counters()
    return pool, want, payloads, got, list(proc.picks), proc.batches, \
        {k: after[k] - before[k] for k in after}


def test_every_candidate_ships_and_the_guard_reverts_a_pick(batch):
    pool, want, *_ = batch
    assert {ship for _, ship in want} == set(range(len(ref.FAST)))
    reverted = [f.kind for f, (pick, ship) in zip(pool, want) if pick != ship]
    assert "reverted" in reverted
    assert all(ship == ref.FAST.index(ref.IDENTITY) for pick, ship in want if pick != ship)


@pytest.mark.parametrize("i", range(sum(c for _, c in POOL["sizes"])))
def test_the_batch_ships_the_references_search_and_guard(batch, i):
    pool, want, payloads, got, picks, *_ = batch
    pick, ship = want[i]
    r = got[i]
    assert r.index == i and picks[i] == pick
    s = ref.FAST[ship]
    assert (r.settings.sort_by_mode, r.settings.split_byte_planes) == \
        (s["sort_by_mode"], s["split_byte_planes"])
    assert r.transformed == ref.transform(tensor(payloads[i]), s).numpy().tobytes()
    if pick != ship:  # a reverted file ships its payload itself, not a copy
        assert r.transformed is payloads[i]


def test_the_counters_are_exact(batch):
    pool, want, payloads, got, picks, batches, delta = batch
    ns = [len(p) // 16 for p in payloads]
    assert delta["modesort.blocks_real"] == sum(ns)
    assert delta["modesort.blocks_launched"] == sum(lanes.bucket_size(n) for n in ns)
    # the guard compressed each LTU pick that is not the identity, and its payload
    assert delta["zstd.buffers"] == 2 * sum(ref.FAST[pick] != ref.IDENTITY
                                            for pick, _ in want)
    assert delta["batch.blocks_real"] == delta["batch.blocks_launched"] == 0
    # the two copies: each payload into its row, each LTU pick's stream out of it
    winners = sum(ref.transform(tensor(p), ref.FAST[pick]).numel()
                  for p, (pick, _) in zip(payloads, want))
    assert delta["batch.copy_bytes_serial"] == sum(map(len, payloads)) + winners
    assert batches == 3  # buckets 2048 (3 files) and 32768 (5 files, two batches)


def ref_settings(s: dict):
    from dxt_lossless_transform_tpu_torch.settings import Bc7TransformSettings

    return Bc7TransformSettings(s["sort_by_mode"], s["split_byte_planes"])


def test_the_guard_compresses_nothing_without_a_pick_to_check():
    data = byte0_mix(100, "every", 1)
    before = backend.counters()
    ModeSortBatchProcessor("bc7", device="cpu", candidates=[ref_settings(ref.IDENTITY)]
                           ).process([data, b""])
    after = backend.counters()
    assert after["zstd.buffers"] == before["zstd.buffers"]
    assert after["modesort.blocks_real"] - before["modesort.blocks_real"] == 100


def test_winners_is_a_stage_of_each_batch_between_the_download_and_the_guard(batch):
    _, _, payloads, *_ = batch
    proc = ModeSortBatchProcessor("bc7", max_batch=MAX_BATCH, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proc.process(payloads)
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("dlt.modesort.")), key=lambda s: s[1])
    (root,) = [s for s in spans if s[0] == "dlt.modesort.process"]
    stages = [s for s in spans if s is not root]
    winners = [s for s in stages if s[0] == "dlt.modesort.winners"]
    assert len(winners) == proc.batches == 3
    assert all(root[1] <= s[1] and s[2] <= root[2] for s in stages)
    names = [s[0].rsplit(".", 1)[1] for s in stages]
    assert names == ["assemble", "h2d", "device", "d2h", "winners", "guard"] * 3


def parent_copies(monkeypatch):
    """The two copies as they were made on one thread: numpy into the pinned rows
    and each winner row's valid bytes into a buffer of its own."""
    def copy(pieces):
        for dst, src, length, fill in pieces:
            d = np.frombuffer(dst, np.uint8) if isinstance(dst, bytearray) else dst
            d[:length] = np.frombuffer(src, np.uint8, length)
            d[length:fill] = 0

    monkeypatch.setattr(host_copy, "copy", copy)
    monkeypatch.setattr(host_copy, "new_bytes", bytearray)


@pytest.mark.parametrize("route", ["calling_thread", "pool"])
def test_the_copier_gives_the_one_thread_copies_bytes(route, monkeypatch):
    rng = np.random.default_rng(7)
    # over SERIAL_BYTES the assembly and the winners run on the pool
    n = (host_copy.SERIAL_BYTES // 16 + 64) if route == "pool" else 3000
    big = rng.integers(0, 256, (n, 16), np.uint8)
    big[:, 0] = 1 << rng.integers(0, 8, n)
    payloads = [big.tobytes(), byte0_mix(700, "invalid", 3)]
    proc = ModeSortBatchProcessor("bc7", max_batch=4, device="cpu")
    before = backend.counters()
    got = proc.process(payloads)
    parallel = backend.counters()["batch.copy_bytes_parallel"] - \
        before["batch.copy_bytes_parallel"]
    assert (parallel > 0) == (route == "pool")
    with monkeypatch.context() as m:
        parent_copies(m)
        want = proc.process(payloads)
    assert [(r.index, r.settings, r.transformed) for r in got] == \
        [(r.index, r.settings, bytes(r.transformed)) for r in want]
