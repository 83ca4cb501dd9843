"""LTU coverage-count kernel (``dlt_ltu_counts`` in ``csrc/bc1_kernels.cu``) and its
plain version.

Replaces ``dxt_lossless_transform_tpu/estimate/pallas_ltu.py:302``
``coverage_scores_pallas`` (``_counts_call`` :262 with the u8-row kernel
``_make_kernel`` :177 and the u32-row kernel ``_make_kernel_packed`` :71). Rows come
as a (C, L) uint8 tensor, or as (C, L/4) int32 words that carry the same bytes; both
reach the one kernel as bytes.

For each row and each position i < ``valid_len`` - 3, with gram(i) the four bytes at
i as a little-endian u32, i is worth ``weights[o]`` of the first offset
``offsets[o]`` (ascending) with i >= k and gram(i) == gram(i - k), and nothing when
there is none. The count is the sum over i, as an exact int64: the TPU kernel
summed in f32, which is exact only below 2**24. The entropy term and the score
are computed outside the kernel (:mod:`.ltu`), as in the JAX package. Any number
of rows works: the C entry point launches the kernel once per 65,535 rows (its
grid.y).

``valid_len`` is one length for every row (``dlt_ltu_counts``) or a (C,) tensor of
one length per row (``dlt_ltu_counts_rows``, the TPU kernel's ``valid_rows``): the
batch pipeline scores every candidate row of a batch of files of different lengths
in one launch. Each row then counts as if it were alone at its own length; the
offsets are kept, and the far instantiation chosen, for the longest row.

:func:`ltu_counts_windowed` (``dlt_ltu_counts_windowed``) replaces
``pallas_ltu.py:328`` ``coverage_counts_windowed``, the partial count of one shard
of the multi-device scorer (:mod:`..parallel.sharded`): each row is
``[SPAN-byte halo | chunk | SPAN-byte halo]`` of a global row, ``pos0`` the global
position of its local byte 0 (the chunk's start - SPAN), and the positions of the
chunk are counted on global terms (the valid lengths, the stream-head guard and the
kept offsets), so that the shards' counts sum to the uncut row's. Offsets up to
SPAN reach into the halo; a larger one raises ``ValueError``, as JAX asserts.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from .. import backend

MAX_OFFSET = 4096   # the near instantiation's backward halo
MAX_OFFSETS = 32    # the near instantiation's offset table
MAX_WEIGHT = 255    # |weight|, so that a block's sum fits 32 bits
SPAN = 32768        # a shard's halo on each side: the TPU kernel's tile


def byte_rows(rows: torch.Tensor) -> torch.Tensor:
    """(C, L) uint8, or (C, L/4) int32 words, -> (C, L) uint8 rows."""
    if rows.dim() != 2:
        raise ValueError(f"expected (C, L) rows, got shape {tuple(rows.shape)}")
    if rows.dtype == torch.int32:
        return rows.contiguous().view(torch.uint8)
    if rows.dtype != torch.uint8:
        raise ValueError(f"expected uint8 or int32 rows, got {rows.dtype}")
    return rows


ValidLen = Union[int, torch.Tensor]


def _check(rows: torch.Tensor, valid_len: ValidLen, offsets: Sequence[int],
           weights: Sequence[int]) -> None:
    if isinstance(valid_len, torch.Tensor):
        if valid_len.shape != (rows.shape[0],):
            raise ValueError(f"valid lengths of shape {tuple(valid_len.shape)} for "
                             f"{rows.shape[0]} rows")
        if valid_len.numel() and not (0 <= int(valid_len.min())
                                      and int(valid_len.max()) <= rows.shape[1]):
            raise ValueError(f"a valid length lies outside [0, {rows.shape[1]}]")
    elif not 0 <= valid_len <= rows.shape[1]:
        raise ValueError(f"valid_len {valid_len} outside [0, {rows.shape[1]}]")
    if len(offsets) != len(weights):
        raise ValueError("offsets and weights differ in length")
    if any(k < 1 for k in offsets) or list(offsets) != sorted(set(offsets)):
        raise ValueError(f"offsets must be positive and ascending, got {offsets}")


def needs_far(offsets: Sequence[int], weights: Sequence[int]) -> bool:
    """Whether the (kept) ladder needs the kernel's far instantiation."""
    return (len(offsets) > MAX_OFFSETS or any(k > MAX_OFFSET for k in offsets)
            or any(w < 0 for w in weights))


def ltu_counts_plain(rows: torch.Tensor, valid_len: ValidLen, offsets: Sequence[int],
                     weights: Sequence[int]) -> torch.Tensor:
    per_row = isinstance(valid_len, torch.Tensor)
    longest = int(valid_len.max()) if per_row and valid_len.numel() else \
        (0 if per_row else valid_len)
    m = longest - 3
    if m <= 0:
        return torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    b = rows[:, :longest].to(torch.int64)
    g = b[:, :m] | (b[:, 1:m + 1] << 8) | (b[:, 2:m + 2] << 16) | (b[:, 3:m + 3] << 24)
    w = torch.zeros(g.shape, dtype=torch.int64, device=rows.device)
    # descending, so that the nearest matching offset's weight is written last
    for k, wk in sorted(zip(offsets, weights), reverse=True):
        if k >= m:
            continue
        w[:, k:] = torch.where(g[:, k:] == g[:, :-k], wk, w[:, k:])
    if per_row:
        # each row's positions i < its own valid length - 3
        ends = valid_len.to(device=rows.device, dtype=torch.int64)[:, None] - 3
        w = torch.where(torch.arange(m, device=rows.device) < ends, w, 0)
    return w.sum(dim=1)


class _Tables:
    """The offset and weight arguments of a count entry point: the ladder's offsets
    below ``longest`` - 3 (an offset k counts only at positions i >= k, and i <
    valid_len - 3), as host arrays, and the far table on ``device`` when the kept
    ladder needs the far instantiation. The far table is freed once the object goes,
    while the kernel may still read it: the caching allocator hands the block out
    again only to work queued after it on this stream."""

    def __init__(self, offsets, weights, longest: int, device: torch.device):
        if any(abs(w) > MAX_WEIGHT for w in weights):
            raise ValueError(f"the kernel takes weights -{MAX_WEIGHT}..{MAX_WEIGHT}")
        kept = [(k, w) for k, w in zip(offsets, weights) if k < longest - 3]
        ks, ws = [k for k, _ in kept], [w for _, w in kept]
        self._far = (torch.tensor(ks + ws, dtype=torch.int64).to(device)
                     if needs_far(ks, ws) else None)
        self._k = (ctypes.c_int64 * max(len(ks), 1))(*ks)
        self._w = (ctypes.c_int64 * max(len(ws), 1))(*ws)
        self.args = (ctypes.addressof(self._k), ctypes.addressof(self._w), len(ks),
                     None if self._far is None else self._far.data_ptr())


def ltu_counts(rows: torch.Tensor, valid_len: ValidLen, offsets: Sequence[int],
               weights: Sequence[int]) -> torch.Tensor:
    """Weighted 4-gram coverage count of each row, as int64 (C,); ``valid_len`` is
    one length or a (C,) tensor of lengths."""
    rows = byte_rows(rows)
    offsets, weights = [int(k) for k in offsets], [int(w) for w in weights]
    per_row = isinstance(valid_len, torch.Tensor)
    if per_row:
        valid_len = valid_len.to(torch.int64)
    _check(rows, valid_len, offsets, weights)
    if not backend.dispatch(rows):
        return ltu_counts_plain(rows, valid_len, offsets, weights)
    backend.require_cuda_tensor(rows, "ltu_counts", torch.uint8, align=1)
    longest = (int(valid_len.max()) if valid_len.numel() else 0) if per_row \
        else valid_len
    tables = _Tables(offsets, weights, longest, rows.device)
    counts = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    if rows.shape[0]:
        if per_row:
            # freed on return like the far table
            valid = valid_len.to(rows.device, non_blocking=True).contiguous()
            backend.launch("dlt_ltu_counts_rows", rows.device, rows.data_ptr(),
                           counts.data_ptr(), rows.shape[0], rows.shape[1],
                           valid.data_ptr(), longest, *tables.args)
        else:
            backend.launch("dlt_ltu_counts", rows.device, rows.data_ptr(),
                           counts.data_ptr(), rows.shape[0], rows.shape[1], valid_len,
                           *tables.args)
    return counts


def _check_window(rows: torch.Tensor, valid_rows: torch.Tensor, offsets, weights) -> None:
    if valid_rows.shape != (rows.shape[0],):
        raise ValueError(f"valid lengths of shape {tuple(valid_rows.shape)} for "
                         f"{rows.shape[0]} rows")
    if rows.shape[1] < 2 * SPAN:
        raise ValueError(f"a window row holds two {SPAN}-byte halos, got "
                         f"{rows.shape[1]} bytes")
    if len(offsets) != len(weights):
        raise ValueError("offsets and weights differ in length")
    if any(k < 1 for k in offsets) or list(offsets) != sorted(set(offsets)):
        raise ValueError(f"offsets must be positive and ascending, got {offsets}")
    if offsets and offsets[-1] > SPAN:
        raise ValueError(f"the halo covers offsets up to {SPAN}, got {offsets[-1]}")


def ltu_counts_windowed_plain(rows: torch.Tensor, valid_rows: torch.Tensor, pos0: int,
                              offsets: Sequence[int], weights: Sequence[int]) -> torch.Tensor:
    c, length = rows.shape
    lo, hi = SPAN, length - SPAN
    if hi <= lo:
        return torch.zeros(c, dtype=torch.int64, device=rows.device)
    b = rows[:, :hi + 3].to(torch.int64)
    g = b[:, :hi] | (b[:, 1:hi + 1] << 8) | (b[:, 2:hi + 2] << 16) | (b[:, 3:hi + 3] << 24)
    cur = g[:, lo:]
    at = pos0 + torch.arange(lo, hi, device=rows.device)  # global positions
    w = torch.zeros(cur.shape, dtype=torch.int64, device=rows.device)
    # descending, so that the nearest matching offset's weight is written last
    for k, wk in sorted(zip(offsets, weights), reverse=True):
        w = torch.where((cur == g[:, lo - k:hi - k]) & (at >= k), wk, w)
    ends = valid_rows.to(device=rows.device, dtype=torch.int64)[:, None] - 3
    return torch.where(at < ends, w, 0).sum(dim=1)


def ltu_counts_windowed(rows: torch.Tensor, valid_rows: torch.Tensor, pos0: int,
                        offsets: Sequence[int], weights: Sequence[int]) -> torch.Tensor:
    """Partial weighted count of one shard's (C, SPAN + Lc + SPAN) window rows (uint8,
    or int32 words that carry the same bytes), as int64 (C,): the chunk's positions,
    each where its global position ``pos0`` + i is below its row's global valid length
    (``valid_rows``, (C,)) - 3, a match at offset k only where ``pos0`` + i >= k."""
    rows = byte_rows(rows)
    offsets, weights = [int(k) for k in offsets], [int(w) for w in weights]
    valid_rows = valid_rows.to(torch.int64)
    _check_window(rows, valid_rows, offsets, weights)
    if not backend.dispatch(rows):
        return ltu_counts_windowed_plain(rows, valid_rows, int(pos0), offsets, weights)
    backend.require_cuda_tensor(rows, "ltu_counts_windowed", torch.uint8, align=1)
    tables = _Tables(offsets, weights, int(valid_rows.max()) if valid_rows.numel() else 0,
                     rows.device)
    counts = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    if rows.shape[0]:
        # freed on return like the far table
        valid = valid_rows.to(rows.device, non_blocking=True).contiguous()
        backend.launch("dlt_ltu_counts_windowed", rows.device, rows.data_ptr(),
                       counts.data_ptr(), rows.shape[0], rows.shape[1], valid.data_ptr(),
                       int(pos0), SPAN, rows.shape[1] - SPAN, *tables.args)
    return counts
