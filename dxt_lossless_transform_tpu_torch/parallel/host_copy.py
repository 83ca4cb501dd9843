"""The batch pipeline's host copies, run on the host's CPUs with the interpreter lock
released.

:func:`copy` takes pieces ``(dst, src, length, fill_to)``: it copies the first
``length`` bytes of ``src`` to the start of ``dst``, then zeroes ``dst`` from there up
to ``fill_to``. A ``dst`` is a writable C-contiguous numpy array, or a ``bytes`` from
:func:`new_bytes` that no one else has seen yet (the C API's way to make a ``bytes``
to fill); a ``src`` is ``bytes`` or any object numpy reads as a buffer. Every length is
checked against both objects before a pointer is taken. The process's
:class:`CopyPool` (made on first use with a thread a CPU the process may run on,
:func:`..estimate.zstd.cpu_budget`, and made anew in a child after ``fork``) runs a
call: the pieces' bytes are cut end to end into one share a thread, so that a large
file is spread over every thread, and the calling thread and the pool's threads each
copy theirs with ``ctypes.memmove`` and ``ctypes.memset``, which release the
interpreter lock, so the copies and the page faults of fresh destinations run at once.
A share is a few calls long: each return from a call takes the interpreter lock again,
which costs tens of microseconds while eight threads want it. A call of fewer than
:data:`SERIAL_BYTES` bytes, where waking the threads costs more than they save, runs
on the calling thread alone.

Counters (``backend.counters()``): ``batch.copy_bytes_parallel`` and
``batch.copy_bytes_serial``, the bytes each call wrote (``fill_to`` a piece) on more
than one thread or on the calling thread alone, and ``batch.copy_threads``, the
threads of the last call that ran on more than one.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from .. import backend
from ..estimate.zstd import cpu_budget

#: a call of fewer bytes runs on the calling thread: on an 8-CPU host, batches of
#: 2-MiB rows gain from 8 MiB up and batches of 512-KiB rows break even at 16 MiB
SERIAL_BYTES = 16 << 20

# the C API's own functions, with the interpreter lock held and its errors raised
_new_bytes = ctypes.PYFUNCTYPE(ctypes.py_object, ctypes.c_void_p, ctypes.c_ssize_t)(
    ("PyBytes_FromStringAndSize", ctypes.pythonapi))
_bytes_data = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.py_object)(
    ("PyBytes_AsString", ctypes.pythonapi))

_pool: Optional["CopyPool"] = None
_pool_lock = threading.Lock()


def new_bytes(n: int) -> bytes:
    """A ``bytes`` of ``n`` bytes whose contents are not set: fill it with
    :func:`copy` before anyone else sees it."""
    return _new_bytes(None, n)


def _address(obj, writable: bool) -> tuple:
    """(address, size) of a piece's buffer."""
    if isinstance(obj, bytes):
        return _bytes_data(obj), len(obj)
    arr = obj if isinstance(obj, np.ndarray) else np.frombuffer(obj, np.uint8)
    if not arr.flags.c_contiguous:
        raise ValueError("a copy's buffer must be C-contiguous")
    if writable and not arr.flags.writeable:
        raise ValueError("a copy's destination must be writable")
    return arr.ctypes.data, arr.nbytes


def _shares(spans: Sequence[tuple], n: int) -> list:
    """The pieces' bytes cut end to end into at most ``n`` shares of equal size (the
    last one shorter), each a list of segments (dst address, src address, bytes to
    copy, bytes to zero after them)."""
    size = -(-sum(fill for *_, fill in spans) // n)
    shares, share, room = [], [], size
    for dst, src, length, fill in spans:
        a = 0
        while a < fill:
            b = min(fill, a + room)
            copied = max(0, min(b, length) - a)
            share.append((dst + a, src + a, copied, b - a - copied))
            room -= b - a
            a = b
            if not room:
                shares.append(share)
                share, room = [], size
    return shares + [share] if share else shares


def _drain(share: list) -> None:
    for dst, src, n, zeros in share:
        if n:
            ctypes.memmove(dst, src, n)
        if zeros:
            ctypes.memset(dst + n, 0, zeros)


class CopyPool:
    """``threads`` - 1 threads kept for the process, which with the caller's thread
    run a call's shares."""

    def __init__(self, threads: int):
        self.threads = threads
        self._executor = (ThreadPoolExecutor(threads - 1, thread_name_prefix="dlt-copy")
                          if threads > 1 else None)

    def run(self, shares: list) -> None:
        """Copy every share, at most :attr:`threads`: the first on the calling
        thread, each other on a thread of the pool."""
        futures = [self._executor.submit(_drain, share) for share in shares[1:]]
        if shares:
            _drain(shares[0])
        for f in futures:
            f.result()

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown()


def pool() -> CopyPool:
    """The process's pool, made on first use with :func:`cpu_budget` threads."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = CopyPool(cpu_budget())
        return _pool


def _forget_pool() -> None:
    """After ``fork``, in the child: its parent's threads do not exist there."""
    global _pool, _pool_lock
    _pool, _pool_lock = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


def copy(pieces: Sequence[tuple]) -> None:
    """Run every piece ``(dst, src, length, fill_to)`` (module docstring) on the
    process's pool, and return when all are done."""
    spans = []
    for dst, src, length, fill in pieces:
        d, dsize = _address(dst, True)
        s, ssize = _address(src, False)
        if not 0 <= length <= min(ssize, fill) or fill > dsize:
            raise ValueError(f"a piece of {length} bytes filled to {fill} does not fit "
                             f"a source of {ssize} and a destination of {dsize} bytes")
        spans.append((d, s, length, fill))
    total = sum(fill for *_, fill in spans)
    copier = pool()
    shares = _shares(spans, 1 if total < SERIAL_BYTES else copier.threads)
    copier.run(shares)
    if len(shares) > 1:
        backend.count("batch.copy_bytes_parallel", total)
        backend.set_count("batch.copy_threads", len(shares))
    else:
        backend.count("batch.copy_bytes_serial", total)
