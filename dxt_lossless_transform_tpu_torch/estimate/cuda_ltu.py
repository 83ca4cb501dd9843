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
offsets are kept for the longest row. Lengths on the host are checked and copied to
the rows' device once per call; a caller that scores several times with the same
lengths (each shard of a mesh step) copies them once itself with
:func:`device_lengths` and passes the :class:`RowLengths` it returns, which carry
the longest length from the host, so that no count call reads anything back from
the card or waits for it.

:func:`ltu_counts_windowed` (``dlt_ltu_counts_windowed``) replaces
``pallas_ltu.py:328`` ``coverage_counts_windowed``, the partial count of one shard
of the multi-device scorer (:mod:`..parallel.sharded`): each row is
``[SPAN-byte halo | chunk | SPAN-byte halo]`` of a global row, ``pos0`` the global
position of its local byte 0 (the chunk's start - SPAN), and the positions of the
chunk are counted on global terms (the valid lengths, the stream-head guard and the
kept offsets), so that the shards' counts sum to the uncut row's. Offsets up to
SPAN reach into the halo; a larger one raises ``ValueError``, as JAX asserts.

Two kernels count. The estimator's whole default ladder (``ltu.DEFAULT_OFFSETS``
with ``offset_weight``) takes the one that compiles that ladder in, in all three
forms and at every row length (its stream-head guard zeroes the offsets that a
short row does not reach); any other ladder, a prefix of the default one too, takes
the generic kernel, which reads it from a table in device memory
(:func:`default_ladder` is the one test). The default kernel chooses its tile
length per launch, so that short launches (a mesh's shards) fill the card;
:func:`launch_shape` reads what a launch would use.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

from .. import backend

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


class RowLengths:
    """One valid length per row, already on the rows' device (``lengths``, (C,)
    int64), with the longest of them from the host (``longest``). ``longest`` sizes
    the grid and keeps the offsets: one below the largest length would count rows
    only in part. So only :func:`device_lengths`, which reads it from the host
    lengths it copies, and :meth:`slice`, whose rows keep the whole set's longest (an
    upper bound, which costs only blocks that exit at once), make one; calling the
    class raises ``TypeError``."""

    __slots__ = ("lengths", "longest")

    def __init__(self, *args, **kwargs):
        raise TypeError("RowLengths come from cuda_ltu.device_lengths or "
                        "RowLengths.slice, which take the longest from the host")

    @classmethod
    def _of(cls, lengths: torch.Tensor, longest: int) -> "RowLengths":
        made = object.__new__(cls)
        made.lengths, made.longest = lengths, longest
        return made

    def __iter__(self):
        return iter((self.lengths, self.longest))

    def slice(self, start: int, stop: int) -> "RowLengths":
        """The lengths of rows ``start`` .. ``stop``, with the same ``longest``."""
        return RowLengths._of(self.lengths[start:stop], self.longest)


ValidLen = Union[int, torch.Tensor, RowLengths]


def _check(rows: torch.Tensor, valid_len: ValidLen, offsets: Sequence[int],
           weights: Sequence[int]) -> None:
    if not isinstance(valid_len, (torch.Tensor, RowLengths)) and \
            not 0 <= valid_len <= rows.shape[1]:
        raise ValueError(f"valid_len {valid_len} outside [0, {rows.shape[1]}]")
    _check_ladder(offsets, weights)


def _check_ladder(offsets: Sequence[int], weights: Sequence[int]) -> None:
    if len(offsets) != len(weights):
        raise ValueError("offsets and weights differ in length")
    if any(k < 1 for k in offsets) or list(offsets) != sorted(set(offsets)):
        raise ValueError(f"offsets must be positive and ascending, got {offsets}")


def default_ladder(offsets: Sequence[int], weights: Sequence[int]) -> bool:
    """Whether the ladder is the estimator's whole default ladder, which the default
    kernel compiles in and counts rung for rung; every other ladder, a prefix of it
    too, takes the generic kernel and its table in device memory."""
    from .ltu import DEFAULT_OFFSETS, offset_weight  # ltu imports this module

    default = [(k, offset_weight(k)) for k in sorted(DEFAULT_OFFSETS)]
    return list(zip(offsets, weights)) == default


def launch_shape(n_rows: int, positions: int, form: str, device: torch.device) -> dict:
    """What a default-ladder launch of ``form`` (``"scalar"``, ``"rows"`` or
    ``"windowed"``) over ``positions`` counted positions of ``n_rows`` rows uses on
    ``device``: its tile length, the first launch's grid and the blocks the card holds
    at once. Launches nothing."""
    tile, gx, gy, resident = backend.query(
        "dlt_ltu_counts_shape", device, n_rows, positions,
        ("scalar", "rows", "windowed").index(form))
    return {"tile": tile, "grid": [gx, gy], "blocks": gx * gy, "resident": resident}


def device_lengths(lengths: torch.Tensor, device: torch.device) -> RowLengths:
    """(C,) valid lengths on the host, checked there, copied to ``device`` as int64
    once, with the longest of them."""
    if not isinstance(lengths, torch.Tensor) or lengths.device.type != "cpu":
        raise ValueError("lengths on a device come as RowLengths, with the longest "
                         "one from the host")
    if lengths.dim() != 1:
        raise ValueError(f"expected (C,) valid lengths, got shape {tuple(lengths.shape)}")
    lengths = lengths.to(torch.int64)
    if lengths.numel() and int(lengths.min()) < 0:
        raise ValueError("a valid length is negative")
    longest = int(lengths.max()) if lengths.numel() else 0
    return RowLengths._of(lengths.to(device, non_blocking=True), longest)


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
    """The offset and weight arguments of a count entry point, as host arrays, and
    the table the generic kernel reads on ``device``. The whole default ladder goes
    to the default kernel uncut, with no table. Any other ladder keeps its offsets
    below ``longest`` - 3 (an offset k counts only at positions i >= k, and i <
    valid_len - 3), in a table of at least one entry, so that its pointer is never
    null (0 offsets count nothing). The table is freed once the object goes, while
    the kernel may still read it: the caching allocator hands the block out again
    only to work queued after it on this stream."""

    def __init__(self, offsets, weights, longest: int, device: torch.device):
        if any(abs(w) > MAX_WEIGHT for w in weights):
            raise ValueError(f"the kernel takes weights -{MAX_WEIGHT}..{MAX_WEIGHT}")
        if default_ladder(offsets, weights):
            ks, ws, self._table = list(offsets), list(weights), None
        else:
            kept = [(k, w) for k, w in zip(offsets, weights) if k < longest - 3]
            ks, ws = [k for k, _ in kept], [w for _, w in kept]
            self._table = torch.tensor(ks + ws or [0], dtype=torch.int64).to(device)
        self._k = (ctypes.c_int64 * max(len(ks), 1))(*ks)
        self._w = (ctypes.c_int64 * max(len(ws), 1))(*ws)
        self.args = (ctypes.addressof(self._k), ctypes.addressof(self._w), len(ks),
                     None if self._table is None else self._table.data_ptr())


def _lengths(valid_len: Union[torch.Tensor, RowLengths], rows: torch.Tensor,
             window: bool = False) -> RowLengths:
    """The rows' lengths on their device: copied there from the host by
    :func:`device_lengths`, or given there, checked as far as the host can without
    reading them. A window's lengths are its rows' global ones and may exceed L."""
    if not isinstance(valid_len, RowLengths):
        valid_len = device_lengths(valid_len, rows.device)
    lengths, longest = valid_len
    if lengths.device != rows.device or lengths.dtype != torch.int64 or \
            lengths.shape != (rows.shape[0],):
        raise ValueError(f"expected int64 lengths of shape ({rows.shape[0]},) on "
                         f"{rows.device}, got {lengths.dtype}{tuple(lengths.shape)} "
                         f"on {lengths.device}")
    if longest < 0 or (not window and longest > rows.shape[1]):
        raise ValueError(f"longest length {longest} outside [0, {rows.shape[1]}]")
    return RowLengths._of(lengths.contiguous(), int(longest))


def ltu_counts(rows: torch.Tensor, valid_len: ValidLen, offsets: Sequence[int],
               weights: Sequence[int]) -> torch.Tensor:
    """Weighted 4-gram coverage count of each row, as int64 (C,); ``valid_len`` is
    one length, a (C,) tensor of lengths on the host, or :class:`RowLengths` on the
    rows' device."""
    rows = byte_rows(rows)
    offsets, weights = [int(k) for k in offsets], [int(w) for w in weights]
    _check(rows, valid_len, offsets, weights)
    per_row = isinstance(valid_len, (torch.Tensor, RowLengths))
    if per_row:
        valid_len, longest = _lengths(valid_len, rows)
    if not backend.dispatch(rows):
        return ltu_counts_plain(rows, valid_len, offsets, weights)
    backend.require_cuda_tensor(rows, "ltu_counts", torch.uint8, align=1)
    tables = _Tables(offsets, weights, longest if per_row else valid_len, rows.device)
    counts = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    if rows.shape[0]:
        if per_row:
            backend.launch("dlt_ltu_counts_rows", rows.device, rows.data_ptr(),
                           counts.data_ptr(), rows.shape[0], rows.shape[1],
                           valid_len.data_ptr(), longest, *tables.args)
        else:
            backend.launch("dlt_ltu_counts", rows.device, rows.data_ptr(),
                           counts.data_ptr(), rows.shape[0], rows.shape[1], valid_len,
                           *tables.args)
    return counts


def _check_window(rows: torch.Tensor, offsets, weights) -> None:
    if rows.shape[1] < 2 * SPAN:
        raise ValueError(f"a window row holds two {SPAN}-byte halos, got "
                         f"{rows.shape[1]} bytes")
    _check_ladder(offsets, weights)
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


def ltu_counts_windowed(rows: torch.Tensor, valid_rows: Union[torch.Tensor, RowLengths],
                        pos0: int, offsets: Sequence[int],
                        weights: Sequence[int]) -> torch.Tensor:
    """Partial weighted count of one shard's (C, SPAN + Lc + SPAN) window rows (uint8,
    or int32 words that carry the same bytes), as int64 (C,): the chunk's positions,
    each where its global position ``pos0`` + i is below its row's global valid length
    (``valid_rows``: (C,) on the host, or :class:`RowLengths` on the rows' device) -
    3, a match at offset k only where ``pos0`` + i >= k."""
    rows = byte_rows(rows)
    offsets, weights = [int(k) for k in offsets], [int(w) for w in weights]
    _check_window(rows, offsets, weights)
    valid_rows, longest = _lengths(valid_rows, rows, window=True)
    if not backend.dispatch(rows):
        return ltu_counts_windowed_plain(rows, valid_rows, int(pos0), offsets, weights)
    backend.require_cuda_tensor(rows, "ltu_counts_windowed", torch.uint8, align=1)
    tables = _Tables(offsets, weights, longest, rows.device)
    counts = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    if rows.shape[0]:
        backend.launch("dlt_ltu_counts_windowed", rows.device, rows.data_ptr(),
                       counts.data_ptr(), rows.shape[0], rows.shape[1],
                       valid_rows.data_ptr(), int(pos0), SPAN, rows.shape[1] - SPAN,
                       *tables.args)
    return counts
