"""Host-endianness boundary layer and big-endian host simulation; the port's copy of
``dxt_lossless_transform_tpu/endian.py`` (:29-89).

The on-disk transformed format is little-endian everywhere: the 4-byte embedded
header, every multi-byte stream lane and the DDS header fields. Every place where the
port's host code reads bytes as multi-byte integers or writes integers as bytes goes
through this module: the DDS header reads (:mod:`.formats.dds`), the transform
header (:mod:`.formats.embed`), the magic that the handler restores
(:mod:`.formats.handlers`), the numpy decoders (:mod:`.oracle.decode`) and the
corpus report of ``debug-format-analysis``. :func:`simulate_big_endian` switches each
of these boundaries to what a correctly ported big-endian host runs: a native
big-endian view followed by the explicit byteswap of ``from_le``/``to_le``. A
boundary that assumed the host's order would give other bytes under the simulation;
:mod:`.utils.endian_harness` checks that none does.

What the simulation cannot reach: the kernels read and write ``uint8`` tensors and
the card is little-endian, so the bytes they see are the file's on any host; the
``.view(torch.int32)`` reinterpretations of the plain versions on CPU tensors
(:mod:`.ops.cuda.shuffle`, :mod:`.ops.cuda.regions`, :mod:`.ops.decode`) run in the
host's real order; and 16- and 32-bit tensors copied back from the card
(:class:`.backend.Download`) arrive in the card's order, which a big-endian host
would have to swap.

The flag is process-global: only the single-threaded harness and the
``debug-endian*`` commands set it, never the CLI's worker threads.
"""

from __future__ import annotations

import struct
from contextlib import contextmanager

import numpy as np

_SIM_BE = False


@contextmanager
def simulate_big_endian():
    """Run the wrapped code as a (simulated) big-endian host would."""
    global _SIM_BE
    prev = _SIM_BE
    _SIM_BE = True
    try:
        yield
    finally:
        _SIM_BE = prev


def simulating_big_endian() -> bool:
    return _SIM_BE


def from_bytes(buf, kind: str) -> np.ndarray:
    """``buf`` as little-endian ``kind`` (``"u2"``, ``"u4"`` or ``"u8"``) lanes.

    A little-endian host views the bytes directly; the simulated big-endian host takes
    the native (``>``) view, which misreads them, and byteswaps it, as a correct
    port's ``from_le`` does. The values are the same either way."""
    if _SIM_BE:
        return np.frombuffer(buf, ">" + kind).byteswap()
    return np.frombuffer(buf, "<" + kind)


def to_bytes(arr, kind: str) -> bytes:
    """Integer lanes as little-endian ``kind`` bytes (``to_le``). On the native path
    an array already of that type is not copied before ``tobytes``."""
    if _SIM_BE:
        return np.asarray(arr).astype(">" + kind).byteswap().tobytes()
    return np.asarray(arr).astype("<" + kind, copy=False).tobytes()


def empty(shape, kind: str) -> np.ndarray:
    """A lane buffer in the host's order (big-endian under the simulation) in which to
    assemble values; serialize it with :func:`to_bytes`, never ``.tobytes()``."""
    return np.empty(shape, (">" if _SIM_BE else "<") + kind)


def pack_u32(value: int) -> bytes:
    """One u32 as 4 little-endian bytes (the embedded header's write)."""
    if _SIM_BE:
        return struct.pack(">I", value & 0xFFFFFFFF)[::-1]
    return struct.pack("<I", value & 0xFFFFFFFF)


def unpack_u32(buf) -> int:
    """4 little-endian bytes as a u32 (the embedded header's read)."""
    if _SIM_BE:
        return struct.unpack(">I", bytes(buf[:4])[::-1])[0]
    return struct.unpack("<I", bytes(buf[:4]))[0]
