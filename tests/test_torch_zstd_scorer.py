"""The port's zstd scorer pool (``estimate/zstd.py``) on the system libzstd: its sizes
are those of a fresh compression context made here at the same level and
parameters, whatever the buffer's type, order, caller or process."""

import os
import random
import select
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.estimate import zstd
from dxt_lossless_transform_tpu_torch.estimate.zstd import ScorerPool, ZstdEstimation

SIZES = (0, 1, 7, 65_536, 300_000, 2_800_000, 5_600_000)


def _buffer(n: int, seed: int) -> bytes:
    """Compressible bytes: runs of a few values with noise, as region streams hold."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.integers(0, 16, n // 64 + 1, np.uint8), 64)[:n]
    return (runs + (rng.random(n) < 0.1) * rng.integers(0, 256, n, np.uint8)).astype(
        np.uint8).tobytes()


BUFFERS = [_buffer(n, i) for i, n in enumerate(SIZES)]


def _fresh_size(data: bytes, level: int) -> int:
    """ZSTD_compress2 on a context made, used and freed here: the magicless frame
    with no content size, checksum or dictionary id."""
    lib = zstd.load_library()
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    cctx = lib.ZSTD_createCCtx()
    try:
        for param, value in ((100, level), (10, 1), (200, 0), (201, 0), (202, 0)):
            assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, param, value))
        ret = lib.ZSTD_compress2(cctx, dst.ctypes.data, dst.size, src.ctypes.data,
                                 src.size)
        assert not lib.ZSTD_isError(ret)
        return ret
    finally:
        lib.ZSTD_freeCCtx(cctx)


FRESH = {level: [_fresh_size(b, level) if b else 0 for b in BUFFERS] for level in (1, 6)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sizes_are_those_of_a_fresh_context(seed):
    """Every size in shuffled order, levels 1 and 6 interleaved on the same workers
    (an empty buffer scores 0, as :meth:`ZstdEstimation.estimate` gives it)."""
    order = list(range(len(BUFFERS)))
    random.Random(seed).shuffle(order)
    for level in (1, 6, 1, 6):
        got = ZstdEstimation(level).estimate_batch([BUFFERS[i] for i in order])
        assert got == [FRESH[level][i] for i in order]
    for i in order:
        assert ZstdEstimation(6 if i % 2 else 1).estimate(BUFFERS[i]) == \
            FRESH[6 if i % 2 else 1][i]


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview", "numpy_view",
                                  "numpy_u32"])
def test_input_types_read_in_place_give_equal_sizes(kind):
    data = BUFFERS[4]
    base = np.frombuffer(b"\x00" * 13 + data + b"\xff" * 3, np.uint8)
    made = {"bytes": lambda: data, "bytearray": lambda: bytearray(data),
            "memoryview": lambda: memoryview(data),
            # a view at an offset into a larger array
            "numpy_view": lambda: base[13:13 + len(data)],
            "numpy_u32": lambda: np.frombuffer(data[:len(data) // 4 * 4], "<u4")}
    buf = made[kind]()
    want = FRESH[1][4] if kind != "numpy_u32" else _fresh_size(data[:len(data) // 4 * 4], 1)
    assert ZstdEstimation(1).estimate_batch([buf, buf]) == [want, want]
    assert ZstdEstimation(1).estimate(buf) == want
    if kind == "numpy_view":
        assert not ZstdEstimation._bytes(buf).flags.owndata  # read where it lies


class _Recording:
    """A job queue that records the size of each buffer put on it."""

    def __init__(self, jobs):
        self.jobs, self.sizes = jobs, []

    def put(self, job):
        if job is not None:
            self.sizes.append(job[3].size)
        self.jobs.put(job)

    def get(self):
        return self.jobs.get()


@pytest.mark.parametrize("workers", [1, 2, 5])
def test_results_come_back_in_submission_order(workers):
    pool = ScorerPool(workers)
    try:
        pool._jobs = _Recording(pool._jobs)
        order = [3, 0, 6, 1, 5, 2, 4]
        bufs = [np.frombuffer(BUFFERS[i], np.uint8) for i in order]
        assert pool.sizes(1, bufs) == [FRESH[1][i] for i in order]
        # queued largest first; the empty buffer is never queued
        assert pool._jobs.sizes == sorted((b.size for b in bufs if b.size), reverse=True)
    finally:
        pool.close()
    assert not any(t.is_alive() for t in pool._threads)


@pytest.mark.parametrize("callers", [4])
def test_concurrent_callers_get_the_same_sizes(callers):
    workers = zstd.scorer_pool().workers
    before = backend.counters()
    results, errors = [None] * callers, []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def call(k):
        try:
            level = (1, 6)[k % 2]
            results[k] = (level, ZstdEstimation(level).estimate_batch(BUFFERS[::-1]))
        except Exception as exc:  # reported by the assertion below
            errors.append(exc)
    try:
        threads = [threading.Thread(target=call, args=(k,)) for k in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors
    assert all(got == FRESH[level][::-1] for level, got in results)
    after = backend.counters()
    assert after["zstd.contexts"] - before["zstd.contexts"] <= workers * 2
    assert after["zstd.worker_us"] > before["zstd.worker_us"]
    assert zstd.cpu_budget() == workers


@pytest.mark.parametrize("level", [1, 6])
def test_a_forked_child_scores_correctly(level):
    est = ZstdEstimation(level)
    assert est.estimate_batch(BUFFERS[:5]) == FRESH[level][:5]  # the parent's pool runs
    read, write = os.pipe()
    with warnings.catch_warnings():  # the warnings that the process has threads
        warnings.simplefilter("ignore")
        pid = os.fork()
    if pid == 0:  # the child: its own pool, made anew
        ok = False
        try:
            ok = (zstd._pool is None
                  and est.estimate_batch(BUFFERS[:5]) == FRESH[level][:5])
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


@pytest.mark.parametrize("text, cpus", [("max 100000\n", 8), ("200000 100000\n", 2),
                                        ("50000 100000\n", 1), ("350000 100000\n", 3),
                                        (None, 8), ("garbage", 8)])
def test_the_pool_size_is_the_affinity_or_the_cgroup_quota(tmp_path, monkeypatch,
                                                           text, cpus):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    path = tmp_path / "cpu.max"
    if text is not None:
        path.write_text(text)
    assert zstd.cpu_budget(str(path)) == cpus


def test_a_compression_error_reaches_the_caller(monkeypatch):
    def no_context(lib, level):
        raise MemoryError("no context")

    pool = ScorerPool(2)
    try:
        # the error is raised in the caller, and the workers live on
        monkeypatch.setattr(zstd, "new_context", no_context)
        with pytest.raises(MemoryError):
            pool.sizes(3, [np.frombuffer(BUFFERS[3], np.uint8)])
        monkeypatch.undo()
        assert pool.sizes(1, [np.frombuffer(BUFFERS[3], np.uint8)]) == [FRESH[1][3]]
    finally:
        pool.close()
