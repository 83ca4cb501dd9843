"""Host zstd size estimation, compression and decompression through the system zstd
library.

Counterpart of ``dxt_lossless_transform_tpu/estimate/zstd.py``: real compression in
the magicless frame format with no content-size, checksum or dictionary-id fields,
so that the estimate is the payload's compressed size alone.
:meth:`ZstdEstimation.compress` returns such a frame and
:meth:`ZstdEstimation.decompress` reads one back, capped at the length the caller
expects (the debug commands use them; the transform paths never compress). The
parameters and calls are those of the JAX package's native runtime
(``runtime/native/dlt_native.cpp:372-400``, ``:403-406``), which compresses with the
same system library, so the two give the same frames. Levels 1-22.

The library is ``libzstd.so.1``, loaded with :mod:`ctypes` when the first estimator
is constructed; the ``zstandard`` package is not used. Where the library cannot be
loaded, the constructor raises :class:`ZstdUnavailableError`.

Estimates run on one process-wide :class:`ScorerPool`, made on first use with a
worker a CPU the process may run on (:func:`cpu_budget`) and made anew in a child
after ``fork``. Each worker keeps one compression context a level, its parameters set
once, and one destination buffer that grows to ``ZSTD_compressBound`` of the largest
buffer it has taken: the pool holds workers × that bound (8 × 5.6 MB for a 4096²
BC3 file's colour section). ``ZSTD_compress2`` starts each frame anew on a reused
context, so every size is that of a fresh context at the same level and parameters.
ctypes releases the interpreter lock during the call, so the workers compress at
once. :meth:`ZstdEstimation.estimate_batch` submits all its buffers together, largest
first, read where they lie, inside the span ``dlt.zstd.estimate``, and counts them
in the counters ``zstd.buffers`` and ``zstd.bytes``; the pool counts
``zstd.contexts`` (contexts made) and ``zstd.worker_us`` (microseconds its workers
spent in ``ZSTD_compress2``) (``backend.counters()``).
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np

from .. import backend
from ..errors import ZstdUnavailableError
from ..utils.profiling import span
from .base import SizeEstimation

LIBRARY = "libzstd.so.1"

# ZSTD_cParameter, ZSTD_dParameter and ZSTD_format_e values (zstd.h)
_C_COMPRESSION_LEVEL = 100
_C_FORMAT = 10               # ZSTD_c_experimentalParam2
_F_ZSTD1_MAGICLESS = 1
_C_CONTENT_SIZE_FLAG = 200
_C_CHECKSUM_FLAG = 201
_C_DICT_ID_FLAG = 202
_D_FORMAT = 1000             # ZSTD_d_experimentalParam1

_P, _S = ctypes.c_void_p, ctypes.c_size_t
_SIGNATURES = {
    "ZSTD_createCCtx": ([], _P),
    "ZSTD_freeCCtx": ([_P], _S),
    "ZSTD_CCtx_setParameter": ([_P, ctypes.c_int, ctypes.c_int], _S),
    "ZSTD_compress2": ([_P, _P, _S, _P, _S], _S),
    "ZSTD_compressBound": ([_S], _S),
    "ZSTD_createDCtx": ([], _P),
    "ZSTD_freeDCtx": ([_P], _S),
    "ZSTD_DCtx_setParameter": ([_P, ctypes.c_int, ctypes.c_int], _S),
    "ZSTD_decompressDCtx": ([_P, _P, _S, _P, _S], _S),
    "ZSTD_isError": ([_S], ctypes.c_uint),
    "ZSTD_getErrorName": ([_S], ctypes.c_char_p),
    "ZSTD_versionNumber": ([], ctypes.c_uint),
}

# the cgroup (v2) file that caps the process's CPU time: "<quota> <period>" or "max ..."
CPU_MAX = "/sys/fs/cgroup/cpu.max"
_PARAMETERS = ((_C_FORMAT, _F_ZSTD1_MAGICLESS), (_C_CONTENT_SIZE_FLAG, 0),
               (_C_CHECKSUM_FLAG, 0), (_C_DICT_ID_FLAG, 0))

_lib: Optional[ctypes.CDLL] = None
_pool: Optional["ScorerPool"] = None
_pool_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The loaded zstd library; raises :class:`ZstdUnavailableError` where
    :data:`LIBRARY` cannot be loaded."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(LIBRARY)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
        except (OSError, AttributeError) as exc:
            raise ZstdUnavailableError(LIBRARY, str(exc)) from None
        _lib = lib
    return _lib


def library_path() -> str:
    """The file the library was loaded from, as the dynamic linker reports it."""

    class _DlInfo(ctypes.Structure):
        _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", _P),
                    ("dli_sname", ctypes.c_char_p), ("dli_saddr", _P)]

    info = _DlInfo()
    symbol = ctypes.cast(load_library().ZSTD_versionNumber, _P)
    if ctypes.CDLL(None).dladdr(symbol, ctypes.byref(info)) and info.dli_fname:
        return info.dli_fname.decode()
    return LIBRARY


def version() -> int:
    """``ZSTD_versionNumber()``: major * 10000 + minor * 100 + patch."""
    return int(load_library().ZSTD_versionNumber())


def _check(lib: ctypes.CDLL, ret: int, what: str) -> int:
    if lib.ZSTD_isError(ret):
        raise RuntimeError(f"zstd {what} failed: {lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def new_context(lib: ctypes.CDLL, level: int) -> int:
    """A compression context with the magicless frame's parameters at ``level``;
    the caller frees it with ``ZSTD_freeCCtx``."""
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise MemoryError("ZSTD_createCCtx failed")
    try:
        for param, value in ((_C_COMPRESSION_LEVEL, level),) + _PARAMETERS:
            _check(lib, lib.ZSTD_CCtx_setParameter(cctx, param, value),
                   f"parameter {param}")
    except RuntimeError:
        lib.ZSTD_freeCCtx(cctx)
        raise
    return cctx


def cpu_budget(cpu_max: str = CPU_MAX) -> int:
    """The CPUs this process may run on: its affinity set, or fewer where the
    cgroup's ``cpu.max`` quota allows fewer whole CPUs (at least 1)."""
    n = len(os.sched_getaffinity(0))
    try:
        with open(cpu_max) as f:
            quota, period = f.read().split()[:2]
        if quota != "max":
            n = min(n, max(1, int(quota) // int(period)))
    except (OSError, ValueError):
        pass
    return n


class _Submission:
    """One caller's buffers in the pool: their sizes, the workers' time in
    ``ZSTD_compress2``, the contexts they made, and the first error."""

    def __init__(self, n: int):
        self.sizes = [0] * n
        self.left = n
        self.ns = self.contexts = 0
        self.error: Optional[BaseException] = None
        self.lock = threading.Lock()
        self.done = threading.Event()
        if not n:
            self.done.set()

    def finish(self, i: int, size: int, ns: int, made: int,
               error: Optional[BaseException]) -> None:
        with self.lock:
            self.sizes[i] = size
            self.ns += ns
            self.contexts += made
            self.error = self.error or error
            self.left -= 1
            if not self.left:
                self.done.set()


class ScorerPool:
    """``workers`` threads that compress buffers with magicless zstd and return
    their sizes. Each keeps a context a level and a destination buffer for its
    life; :meth:`close` ends them and frees their contexts."""

    def __init__(self, workers: int):
        self.workers = workers
        self._lib = load_library()
        self._jobs = queue.SimpleQueue()
        self._threads = [threading.Thread(target=self._work, name=f"dlt-zstd-{i}",
                                          daemon=True) for i in range(workers)]
        for t in self._threads:
            t.start()

    def _work(self) -> None:
        lib = self._lib
        contexts = {}
        dst = np.empty(0, np.uint8)
        try:
            while True:
                job = self._jobs.get()
                if job is None:
                    return
                sub, i, level, src = job
                size = ns = made = 0
                error = None
                try:
                    cctx = contexts.get(level)
                    if cctx is None:
                        cctx = contexts[level] = new_context(lib, level)
                        made = 1
                    bound = lib.ZSTD_compressBound(src.size)
                    if dst.size < bound:
                        dst = np.empty(bound, np.uint8)
                    t = time.perf_counter_ns()
                    ret = lib.ZSTD_compress2(cctx, dst.ctypes.data, dst.size,
                                             src.ctypes.data, src.size)
                    ns = time.perf_counter_ns() - t
                    size = _check(lib, ret, "compression")
                except Exception as exc:  # handed to the caller, which raises it
                    error = exc
                sub.finish(i, size, ns, made, error)
        finally:
            for cctx in contexts.values():
                lib.ZSTD_freeCCtx(cctx)

    def sizes(self, level: int, buffers: Sequence[np.ndarray]) -> list:
        """The magicless zstd size of each contiguous uint8 array at ``level``, in
        their order (0 for an empty one). All are queued at once, largest first; the
        caller waits for its own."""
        sub = _Submission(len(buffers))
        for i in sorted(range(len(buffers)), key=lambda i: -buffers[i].size):
            if buffers[i].size:
                self._jobs.put((sub, i, level, buffers[i]))
            else:
                sub.finish(i, 0, 0, 0, None)
        sub.done.wait()
        backend.count("zstd.contexts", sub.contexts)
        backend.count("zstd.worker_us", sub.ns // 1000)
        if sub.error is not None:
            raise sub.error
        return sub.sizes

    def close(self) -> None:
        for _ in self._threads:
            self._jobs.put(None)
        for t in self._threads:
            t.join()


def scorer_pool() -> ScorerPool:
    """The process's pool, made on first use with :func:`cpu_budget` workers."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ScorerPool(cpu_budget())
        return _pool


def _forget_pool() -> None:
    """After ``fork``, in the child: its parent's workers do not exist there."""
    global _pool, _pool_lock
    _pool, _pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


class ZstdEstimation(SizeEstimation):
    """Estimate the compressed size by compressing with magicless zstd."""

    def __init__(self, level: int = 1):
        if not 1 <= level <= 22:
            raise ValueError(f"zstd level {level} out of range 1..22")
        self.level = level
        self._lib = load_library()

    def max_compressed_size(self, len_bytes: int) -> int:
        return len_bytes + (len_bytes >> 8) + 512

    @staticmethod
    def _bytes(data) -> np.ndarray:
        if isinstance(data, np.ndarray):
            return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        return np.frombuffer(data, np.uint8)

    def estimate(self, data) -> int:
        return scorer_pool().sizes(self.level, [self._bytes(data)])[0]

    def compress(self, data) -> bytes:
        """The magicless zstd frame of ``data`` at this estimator's level."""
        lib = self._lib
        src = self._bytes(data)
        dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
        cctx = new_context(lib, self.level)
        try:
            n = _check(lib, lib.ZSTD_compress2(cctx, dst.ctypes.data, dst.size,
                                               src.ctypes.data, src.size), "compression")
        finally:
            lib.ZSTD_freeCCtx(cctx)
        return dst[:n].tobytes()

    def decompress(self, data: bytes, expected_len: int) -> bytes:
        """The bytes of the magicless frame ``data``, at most ``expected_len`` of
        them; a frame that holds more, or any zstd error, raises ``RuntimeError``."""
        lib = self._lib
        src = self._bytes(data)
        dst = np.empty(max(expected_len, 1), np.uint8)
        dctx = lib.ZSTD_createDCtx()
        if not dctx:
            raise MemoryError("ZSTD_createDCtx failed")
        try:
            _check(lib, lib.ZSTD_DCtx_setParameter(dctx, _D_FORMAT, _F_ZSTD1_MAGICLESS),
                   "parameter format")
            n = _check(lib, lib.ZSTD_decompressDCtx(dctx, dst.ctypes.data, expected_len,
                                                    src.ctypes.data, src.size),
                       "decompression")
        finally:
            lib.ZSTD_freeDCtx(dctx)
        return dst[:n].tobytes()

    def estimate_batch(self, regions: Sequence) -> list:
        """Each buffer's estimate (``bytes``, ``bytearray``, ``memoryview`` or a
        contiguous numpy array, read in place), all submitted to the pool at once."""
        srcs = [self._bytes(r) for r in regions]
        nbytes = sum(s.size for s in srcs)
        backend.count("zstd.buffers", len(srcs))
        backend.count("zstd.bytes", nbytes)
        with span("dlt.zstd.estimate", f"buffers={len(srcs)} bytes={nbytes}"):
            return scorer_pool().sizes(self.level, srcs)
