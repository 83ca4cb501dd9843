"""The compressed size of a buffer under zstd level 1, through the system's
``libzstd.so.1`` with :mod:`ctypes`, in the size estimator's parameters upstream
(``compressors/dxt-lossless-transform-zstd/src/lib.rs:183-199``): level 1, the
magicless frame format, and no content-size, checksum or dictionary-id field, so
that the size is the compressed payload's alone. Written against ``zstd.h``; it
imports nothing of the package under test.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

LIBRARY = "libzstd.so.1"
LEVEL = 1
# (ZSTD_cParameter, value): ZSTD_c_compressionLevel; ZSTD_c_format (the experimental
# parameter 2) = ZSTD_f_zstd1_magicless; ZSTD_c_contentSizeFlag, ZSTD_c_checksumFlag,
# ZSTD_c_dictIDFlag off
PARAMETERS = ((100, LEVEL), (10, 1), (200, 0), (201, 0), (202, 0))

_P, _S = ctypes.c_void_p, ctypes.c_size_t


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(LIBRARY)
    for name, args, res in (("ZSTD_createCCtx", [], _P), ("ZSTD_freeCCtx", [_P], _S),
                            ("ZSTD_CCtx_setParameter", [_P, ctypes.c_int, ctypes.c_int], _S),
                            ("ZSTD_compress2", [_P, _P, _S, _P, _S], _S),
                            ("ZSTD_compressBound", [_S], _S),
                            ("ZSTD_isError", [_S], ctypes.c_uint),
                            ("ZSTD_getErrorName", [_S], ctypes.c_char_p)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _checked(lib, ret: int) -> int:
    if lib.ZSTD_isError(ret):
        raise RuntimeError(f"zstd: {lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def size(data) -> int:
    """Bytes of ``data`` (a bytes-like object or a uint8 array) compressed by zstd
    level 1 in the magicless frame; 0 for no bytes."""
    src = np.ascontiguousarray(np.frombuffer(data, np.uint8)
                               if not isinstance(data, np.ndarray) else data).reshape(-1)
    if src.size == 0:
        return 0
    lib = library()
    dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise MemoryError("ZSTD_createCCtx failed")
    try:
        for param, value in PARAMETERS:
            _checked(lib, lib.ZSTD_CCtx_setParameter(cctx, param, value))
        return _checked(lib, lib.ZSTD_compress2(cctx, dst.ctypes.data, dst.size,
                                                src.ctypes.data, src.size))
    finally:
        lib.ZSTD_freeCCtx(cctx)
