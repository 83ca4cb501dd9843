"""The batch pipeline's host copier (``parallel/host_copy.py``) on the CPU: every
piece ``(dst, src, length, fill_to)`` gives what the numpy copies it replaces give
(the payload into a staging row with a zeroed tail, a row's head into a new
``bytes``), whatever the pool's width and the number of pieces; the shares tile every
piece once, their edges anywhere in it; bytes past ``fill_to`` are left alone; a piece that does not fit raises before any
byte is written; the counters tell the calling thread's bytes from the pool's; a
forked child makes its own pool."""

import os
import select
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.estimate.zstd import cpu_budget
from dxt_lossless_transform_tpu_torch.parallel import host_copy
from dxt_lossless_transform_tpu_torch.parallel.host_copy import CopyPool

SENTINEL = 0xA5


@pytest.fixture(scope="module")
def pools():
    made = {w: CopyPool(w) for w in (1, 2, 3, 8)}
    yield made
    for p in made.values():
        p.close()


def source(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def expected(dst_size: int, src: bytes, length: int, fill: int) -> np.ndarray:
    """The numpy copy the copier replaces, on a destination of sentinels."""
    want = np.full(dst_size, SENTINEL, np.uint8)
    want[:length] = np.frombuffer(src, np.uint8)[:length]
    want[length:fill] = 0
    return want


def copy_on(pool, pieces, monkeypatch) -> None:
    """``host_copy.copy(pieces)`` with ``pool`` as the process's pool."""
    monkeypatch.setattr(host_copy, "_pool", pool)
    host_copy.copy(pieces)


def run_pieces(specs, pool, monkeypatch):
    """Each spec (dst size, src size, length, fill), copied on ``pool`` whatever the
    call's size: -> (destinations, wanted)."""
    monkeypatch.setattr(host_copy, "_pool", pool)
    monkeypatch.setattr(host_copy, "SERIAL_BYTES", 0)
    dsts, want, pieces = [], [], []
    for i, (dsize, ssize, length, fill) in enumerate(specs):
        src = source(ssize, i)
        dst = np.full(dsize, SENTINEL, np.uint8)
        dsts.append(dst)
        want.append(expected(dsize, src, length, fill))
        pieces.append((dst, src, length, fill))
    host_copy.copy(pieces)
    return dsts, want


# (dst size, src size, length, fill_to)
EDGES = [
    (0, 0, 0, 0),          # nothing at all
    (16, 5, 0, 0),         # a piece of 0 bytes
    (16, 5, 0, 11),        # zeros alone
    (33, 33, 33, 33),      # odd, the whole row
    (50, 40, 37, 45),      # odd length, fill beyond it, sentinels after
    (64, 64, 31, 64),      # length one below a share's end (width 2)
    (64, 64, 32, 64),      # length on a share's end
    (64, 64, 33, 64),      # length one past a share's end
    (96, 70, 64, 65),      # fill one past a share's end (width 8)
    (200, 200, 199, 200),  # the last share one byte of zeros
]


@pytest.mark.parametrize("width", [1, 2, 3, 8])
@pytest.mark.parametrize("spec", EDGES, ids=lambda s: "x".join(map(str, s)))
def test_a_piece_is_the_numpy_copy(spec, width, pools, monkeypatch):
    dsts, want = run_pieces([spec], pools[width], monkeypatch)
    np.testing.assert_array_equal(dsts[0], want[0])


def random_specs(seed: int, n: int = 29) -> list:
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(n):
        ssize = int(rng.integers(0, 300))
        length = int(rng.integers(0, ssize + 1))
        fill = length + int(rng.integers(0, 100))
        specs.append((fill + int(rng.integers(0, 20)), ssize, length, fill))
    return specs


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("width", [1, 3, 8])
def test_more_pieces_than_threads(width, seed, pools, monkeypatch):
    dsts, want = run_pieces(random_specs(seed), pools[width], monkeypatch)
    for d, w in zip(dsts, want):
        np.testing.assert_array_equal(d, w)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 64])
def test_the_shares_tile_every_piece_once(n):
    """Shares of equal bytes (the last shorter), at most ``n``; each piece's
    segments follow each other from 0 to ``fill_to``, a segment's zeros after its
    copy, copied bytes only below ``length`` and zeros only above it."""
    specs = random_specs(n, 40)
    spans = [(i << 32, (i << 32) + (1 << 31), length, fill)
             for i, (_, _, length, fill) in enumerate(specs)]
    total = sum(fill for *_, fill in spans)
    shares = host_copy._shares(spans, n)
    sizes = [sum(c + z for _, _, c, z in share) for share in shares]
    assert len(shares) <= n and sum(sizes) == total
    assert set(sizes[:-1]) <= {-(-total // n)} and sizes[-1] <= -(-total // n)
    at = {}
    for dst, src, copied, zeros in (seg for share in shares for seg in share):
        i, offset = dst >> 32, dst & 0xFFFFFFFF
        assert src == dst + (1 << 31) and copied + zeros > 0
        assert at.get(i, 0) == offset
        length = spans[i][2]
        assert not copied or offset + copied <= length
        assert not zeros or offset + copied >= length
        at[i] = offset + copied + zeros
    assert at == {i: fill for i, (*_, fill) in enumerate(spans) if fill}


@pytest.mark.parametrize("serial_bytes", [0, 1 << 40], ids=["parallel", "serial"])
@pytest.mark.parametrize("width", [1, 8])
def test_a_staging_batch_and_its_results_are_the_numpy_copies(width, serial_bytes, pools,
                                                              monkeypatch):
    """The batch pipeline's two uses: payloads into rows of a staging buffer with
    zeroed tails and the last file repeated, then each row's head into a new
    ``bytes`` (the parent's ``host[row, :size] = ...; host[row, size:] = 0`` and
    ``rows[row, :size].tobytes()``)."""
    monkeypatch.setattr(host_copy, "SERIAL_BYTES", serial_bytes)
    payloads = [source(n, n) for n in (4000, 17, 2999, 4096, 1)]
    laid = list(range(len(payloads))) + [len(payloads) - 1] * 3
    host = np.full((len(laid), 4096), SENTINEL, np.uint8)
    copy_on(pools[width], [(host[row], payloads[i], len(payloads[i]), host.shape[1])
                    for row, i in enumerate(laid)], monkeypatch)
    want = np.zeros_like(host)
    for row, i in enumerate(laid):
        want[row, :len(payloads[i])] = np.frombuffer(payloads[i], np.uint8)
    np.testing.assert_array_equal(host, want)

    outs = [host_copy.new_bytes(len(p)) for p in payloads]
    copy_on(pools[width], [(out, host[row], len(out), len(out))
                    for row, out in enumerate(outs)], monkeypatch)
    assert all(type(o) is bytes for o in outs)
    assert outs == [host[row, :len(p)].tobytes() for row, p in enumerate(payloads)]
    assert outs == payloads


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview", "uint32 array"])
def test_a_source_is_any_buffer(kind, pools, monkeypatch):
    data = source(64, 1)
    src = {"bytes": data, "bytearray": bytearray(data), "memoryview": memoryview(data),
           "uint32 array": np.frombuffer(data, np.uint32).copy()}[kind]
    monkeypatch.setattr(host_copy, "SERIAL_BYTES", 0)
    dst = np.zeros(80, np.uint8)
    copy_on(pools[3], [(dst, src, 64, 80)], monkeypatch)
    assert dst.tobytes() == data + bytes(16)


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_new_bytes_are_bytes_of_their_length_that_own_their_memory(n, pools,
                                                                   monkeypatch):
    out = host_copy.new_bytes(n)
    assert type(out) is bytes and len(out) == n
    data = source(n, n)
    copy_on(pools[2], [(out, data, n, n)], monkeypatch)
    assert out == data
    del data
    assert out == source(n, n)


@pytest.mark.parametrize("piece, match", [
    (lambda: (np.zeros(8, np.uint8), bytes(16), 9, 9), "does not fit"),
    (lambda: (np.zeros(8, np.uint8), bytes(4), 5, 8), "does not fit"),
    (lambda: (np.zeros(8, np.uint8), bytes(8), 6, 5), "does not fit"),
    (lambda: (np.zeros(8, np.uint8), bytes(8), -1, 5), "does not fit"),
    (lambda: (np.zeros((4, 4), np.uint8)[:, 0], bytes(4), 4, 4), "C-contiguous"),
    (lambda: (np.frombuffer(bytes(8), np.uint8), bytes(8), 8, 8), "writable"),
], ids=["fill-past-dst", "length-past-src", "length-past-fill", "negative",
        "strided", "read-only"])
def test_a_piece_that_does_not_fit_raises_before_any_copy(piece, match, pools,
                                                          monkeypatch):
    first = np.zeros(4, np.uint8)
    with pytest.raises(ValueError, match=match):
        copy_on(pools[3], [(first, b"\x01\x02\x03\x04", 4, 4), piece()], monkeypatch)
    assert not first.any()


def test_the_counters_tell_the_calling_threads_bytes_from_the_pools(pools, monkeypatch):
    monkeypatch.setattr(host_copy, "SERIAL_BYTES", 1000)
    backend.reset_counters()
    dst = np.zeros(4000, np.uint8)
    copy_on(pools[8], [(dst[:999], bytes(500), 500, 999)], monkeypatch)
    copy_on(pools[8], [(dst, bytes(4000), 3000, 4000)], monkeypatch)
    copy_on(pools[3], [(dst[:100], bytes(100), 100, 100),
                       (dst[100:1100], bytes(1), 1, 1000)], monkeypatch)
    copy_on(pools[1], [(dst, bytes(4000), 4000, 4000)], monkeypatch)
    c = backend.counters()
    assert c["batch.copy_bytes_serial"] == 999 + 4000
    assert c["batch.copy_bytes_parallel"] == 4000 + 1100
    assert c["batch.copy_threads"] == 3  # the last call on more than one thread
    backend.reset_counters()
    assert backend.counters()["batch.copy_threads"] == 0


def test_the_process_pool_is_one_of_cpu_budget_threads():
    assert host_copy.pool() is host_copy.pool()
    assert host_copy.pool().threads == cpu_budget()


def test_copies_from_many_callers_at_once_are_each_whole(pools, monkeypatch):
    """Eight callers share a pool of three threads, with the interpreter switching
    threads as often as it can: every call's pieces are copied whole."""
    monkeypatch.setattr(host_copy, "_pool", pools[3])
    monkeypatch.setattr(host_copy, "SERIAL_BYTES", 0)
    errors = []

    def caller(k):
        try:
            for r in range(20):
                src = source(500 + k, k * 100 + r)
                dst = np.full(600, SENTINEL, np.uint8)
                host_copy.copy([(dst[:300], src, 250, 300),
                                (dst[300:], src[250:], 200, 290)])
                want = np.concatenate([expected(300, src, 250, 300),
                                       expected(300, src[250:], 200, 290)])
                np.testing.assert_array_equal(dst, want)
        except Exception as exc:  # handed to the test's thread
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        callers = [threading.Thread(target=caller, args=(k,)) for k in range(8)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in callers)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors[0]


def test_a_forked_child_copies_on_a_pool_of_its_own(monkeypatch):
    monkeypatch.setattr(host_copy, "SERIAL_BYTES", 0)
    host_copy.copy([(np.zeros(4 << 20, np.uint8), bytes(4 << 20), 4 << 20, 4 << 20)])
    read, write = os.pipe()
    with warnings.catch_warnings():  # the warnings that the process has threads
        warnings.simplefilter("ignore")
        pid = os.fork()
    if pid == 0:  # the child: its own pool, made anew
        ok = False
        try:
            fresh = host_copy._pool is None
            data = source(3 << 20, 5)
            dst = np.zeros(4 << 20, np.uint8)
            host_copy.copy([(dst, data, len(data), dst.size)])
            ok = fresh and dst.tobytes() == data + bytes(1 << 20)
        finally:
            os.write(write, b"1" if ok else b"0")
            os._exit(0)
    os.close(write)
    try:
        ready, _, _ = select.select([read], [], [], 120)
        assert ready, "the forked child did not answer"
        assert os.read(read, 1) == b"1"
    finally:
        os.close(read)
        deadline = time.monotonic() + 30
        while os.waitpid(pid, os.WNOHANG) == (0, 0) and time.monotonic() < deadline:
            time.sleep(0.05)
