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
loaded, the constructor raises :class:`ZstdUnavailableError`. Each estimate creates,
uses and frees its own compression context, and ctypes releases the interpreter
lock during the call, so :meth:`ZstdEstimation.estimate_batch` runs its buffers in
threads, inside the span ``dlt.zstd.estimate``, and counts them in the counters
``zstd.buffers`` and ``zstd.bytes`` (``backend.counters()``).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
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

_lib: Optional[ctypes.CDLL] = None


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


class ZstdEstimation(SizeEstimation):
    """Estimate the compressed size by compressing with magicless zstd."""

    def __init__(self, level: int = 1):
        if not 1 <= level <= 22:
            raise ValueError(f"zstd level {level} out of range 1..22")
        self.level = level
        self._lib = load_library()

    def max_compressed_size(self, len_bytes: int) -> int:
        return len_bytes + (len_bytes >> 8) + 512

    def _check(self, ret: int, what: str) -> int:
        if self._lib.ZSTD_isError(ret):
            raise RuntimeError(f"zstd {what} failed: "
                               f"{self._lib.ZSTD_getErrorName(ret).decode()}")
        return ret

    @staticmethod
    def _bytes(data) -> np.ndarray:
        if isinstance(data, np.ndarray):
            return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        return np.frombuffer(data, np.uint8)

    def _compress(self, src: np.ndarray) -> tuple:
        """(destination buffer, compressed length) of ``src`` in the magicless frame."""
        lib = self._lib
        dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
        cctx = lib.ZSTD_createCCtx()
        if not cctx:
            raise MemoryError("ZSTD_createCCtx failed")
        try:
            for param, value in ((_C_COMPRESSION_LEVEL, self.level),
                                 (_C_FORMAT, _F_ZSTD1_MAGICLESS),
                                 (_C_CONTENT_SIZE_FLAG, 0), (_C_CHECKSUM_FLAG, 0),
                                 (_C_DICT_ID_FLAG, 0)):
                self._check(lib.ZSTD_CCtx_setParameter(cctx, param, value),
                            f"parameter {param}")
            return dst, self._check(lib.ZSTD_compress2(cctx, dst.ctypes.data, dst.size,
                                                       src.ctypes.data, src.size),
                                    "compression")
        finally:
            lib.ZSTD_freeCCtx(cctx)

    def estimate(self, data) -> int:
        src = self._bytes(data)
        if src.size == 0:
            return 0
        return self._compress(src)[1]

    def compress(self, data) -> bytes:
        """The magicless zstd frame of ``data`` at this estimator's level."""
        dst, n = self._compress(self._bytes(data))
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
            self._check(lib.ZSTD_DCtx_setParameter(dctx, _D_FORMAT, _F_ZSTD1_MAGICLESS),
                        "parameter format")
            n = self._check(lib.ZSTD_decompressDCtx(dctx, dst.ctypes.data, expected_len,
                                                    src.ctypes.data, src.size),
                            "decompression")
        finally:
            lib.ZSTD_freeDCtx(dctx)
        return dst[:n].tobytes()

    def estimate_batch(self, regions: Sequence) -> list:
        """Each buffer's estimate, one thread per buffer up to the CPU count."""
        nbytes = sum(memoryview(r).nbytes for r in regions)
        backend.count("zstd.buffers", len(regions))
        backend.count("zstd.bytes", nbytes)
        with span("dlt.zstd.estimate", f"buffers={len(regions)} bytes={nbytes}"):
            if len(regions) < 2:
                return [self.estimate(r) for r in regions]
            with ThreadPoolExecutor(min(len(regions), os.cpu_count() or 1)) as pool:
                return list(pool.map(self.estimate, regions))
