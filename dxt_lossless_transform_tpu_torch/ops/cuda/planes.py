"""BC7/BC6H mode-sort kernels and their plain versions, with the host helpers of the
mode sort (the port's own copy of ``dxt_lossless_transform_tpu/oracle/bc7.py:36-118``
and ``oracle/bc6h.py:29-41``).

``dlt_bc7_transform`` and ``dlt_bc7_untransform`` (``csrc/bc7_kernels.cu``) replace
the Pallas passes of ``dxt_lossless_transform_tpu/ops/pallas/planes.py`` around the
XLA sort: ``:280`` ``split_cols_modes_tpu``, ``:46`` ``split_planes_tpu``, ``:77``
``split_planes_flat_tpu`` and ``:139`` ``weave_cols_tpu`` forward, ``:116``
``merge_planes_flat_tpu``, ``:218`` ``merge_planes_tpu`` and ``:186``
``split_cols_tpu`` back. For n blocks (uint8[16n]) the transform writes the on-disk
layout:

- with ``sort``: the mode stream (``ceil(n/2)`` bytes, two 4-bit ids per byte, low
  nibble first, the high nibble of an odd last block 0), then the payload;
- without: the payload alone;

where the payload is the blocks, stably sorted by mode id within each chunk of
:data:`SORT_CHUNK_BLOCKS` blocks (the ragged last chunk on its own) when sorting,
either block by block or as 16 byte planes (plane p = byte p of every block). A
block's mode id comes from its byte 0 through :data:`MODE_TABLES`: BC7's count of
trailing zero bits (8 for 0, an invalid block) or BC6H's grouping id. The
untransform reads the ids from the stream, so it needs no format.

The plain versions index the 256-entry table, order each chunk with a stable
``torch.sort``, move the blocks with ``index_select`` (``.t().contiguous()`` for the
planes) and invert by ``index_copy_``.

``dlt_deinterleave_words`` (``csrc/words_kernels.cu``) replaces ``:159``
``deinterleave_words_tpu``: int32[k·N] -> k int32[N] streams with
``out[i][j] == x[k·j + i]``, k in {2, 4}, any N (the TPU kernel needed k·N % 2048 ==
0). The corpus batch steps (:mod:`..parallel.sharded`) run it on each whole flat
batch. Its plain version is ``x.view(-1, k).unbind(1)`` made contiguous.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import backend
from .shuffle import _check_blocks

BLOCK_SIZE = 16
SORT_CHUNK_BLOCKS = 4096  # mode-sort granularity: 64 KiB of payload per chunk

# the ``fmt`` argument of the transform
BC7, BC6H = 0, 1

# byte 0 -> mode id. BC7: trailing zero bits, 0 -> 8 (the invalid block sorts after
# every real mode).
_CTZ8 = np.array([8] + [(v & -v).bit_length() - 1 for v in range(1, 256)], np.uint8)


def _bc6h_id(b0: int) -> int:
    """BC6H: ids 0-1 for the 2-bit modes, 2-9 for the two-region 5-bit modes, 10-13
    for the one-region ones and 14 for the reserved patterns."""
    if b0 & 3 < 2:
        return b0 & 3
    v = b0 & 31
    return 10 + min(v >> 2, 4) if v & 1 else 2 + (v >> 2)


MODE_TABLES = {BC7: _CTZ8,
               BC6H: np.array([_bc6h_id(b) for b in range(256)], np.uint8)}


def mode_stream_len(n_blocks: int) -> int:
    """Length in bytes of the packed 4-bit mode stream."""
    return (n_blocks + 1) // 2


def transformed_len(n_blocks: int, sort: bool) -> int:
    return BLOCK_SIZE * n_blocks + (mode_stream_len(n_blocks) if sort else 0)


def mode_ids(x: torch.Tensor, fmt: int) -> torch.Tensor:
    """Each block's mode id (uint8[n]) from byte 0 of the blocks ``x`` (uint8[16n])."""
    table = torch.from_numpy(MODE_TABLES[fmt]).to(x.device)
    return table[x.view(-1, BLOCK_SIZE)[:, 0].long()]


def pack_mode_stream(modes: torch.Tensor) -> torch.Tensor:
    """Mode ids (uint8[n]) -> the stream (uint8[ceil(n/2)]), low nibble first, the odd
    tail padded with 0."""
    padded = torch.zeros(2 * mode_stream_len(modes.numel()), dtype=torch.uint8,
                         device=modes.device)
    padded[:modes.numel()] = modes
    return padded[0::2] | (padded[1::2] << 4)


def unpack_mode_stream(stream: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Inverse of :func:`pack_mode_stream`: the first ``n_blocks`` ids."""
    if stream.numel() < mode_stream_len(n_blocks):
        raise ValueError("mode stream shorter than the block count requires")
    return torch.stack([stream & 0x0F, stream >> 4], dim=1).reshape(-1)[:n_blocks]


def sort_order(modes: torch.Tensor) -> torch.Tensor:
    """The chunk-local stable mode sort: ``order[p]`` is the original index of the
    block at sorted position p (int64[n])."""
    n, c = modes.numel(), SORT_CHUNK_BLOCKS
    keys = modes.to(torch.int16)
    order = torch.empty(n, dtype=torch.int64, device=modes.device)
    full = n // c * c
    if full:
        per_chunk = torch.sort(keys[:full].view(-1, c), dim=1, stable=True).indices
        base = torch.arange(0, full, c, dtype=torch.int64, device=modes.device)
        order[:full] = (per_chunk + base[:, None]).reshape(-1)
    if n > full:
        order[full:] = full + torch.sort(keys[full:], stable=True).indices
    return order


def bc7_transform_plain(x: torch.Tensor, fmt: int, sort: bool,
                        planes: bool) -> torch.Tensor:
    blocks = x.view(-1, BLOCK_SIZE)
    parts = []
    if sort:
        modes = mode_ids(x, fmt)
        parts.append(pack_mode_stream(modes))
        blocks = blocks.index_select(0, sort_order(modes))
    parts.append((blocks.t() if planes else blocks).contiguous().view(-1))
    return torch.cat(parts)


def bc7_untransform_plain(x: torch.Tensor, n: int, sort: bool,
                          planes: bool) -> torch.Tensor:
    msl = mode_stream_len(n) if sort else 0
    payload = x[msl:]
    blocks = payload.view(BLOCK_SIZE, n).t() if planes else payload.view(n, BLOCK_SIZE)
    if not sort:
        return blocks.contiguous().view(-1)
    out = torch.empty((n, BLOCK_SIZE), dtype=torch.uint8, device=x.device)
    out.index_copy_(0, sort_order(unpack_mode_stream(x[:msl], n)), blocks)
    return out.view(-1)


def bc7_transform(x: torch.Tensor, fmt: int, sort: bool, planes: bool,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BC7 or BC6H blocks (uint8[16n]) -> the transformed bytes (uint8[16n +
    ceil(n/2)] when sorting, else uint8[16n]), written into ``out`` when it is given
    (a 1-D uint8 tensor of that length on ``x``'s device, any alignment)."""
    n = _check_blocks(x, "bc7_transform", BLOCK_SIZE)
    if fmt not in MODE_TABLES:
        raise ValueError(f"fmt must be {BC7} (BC7) or {BC6H} (BC6H), got {fmt}")
    length = transformed_len(n, sort)
    if out is not None and (out.dtype != torch.uint8 or out.shape != (length,)
                            or out.device != x.device):
        raise ValueError(f"bc7_transform: out must be uint8[{length}] on {x.device}, "
                         f"got {out.dtype}{tuple(out.shape)} on {out.device}")
    if not backend.dispatch(x):
        result = bc7_transform_plain(x, fmt, sort, planes)
        return result if out is None else out.copy_(result)
    backend.require_cuda_tensor(x, "bc7_transform", torch.uint8, align=16)
    if out is None:
        out = torch.empty(length, dtype=torch.uint8, device=x.device)
    backend.require_cuda_tensor(out, "bc7_transform out", torch.uint8, align=1)
    if n:
        backend.launch("dlt_bc7_transform", x.device, x.data_ptr(), out.data_ptr(), n,
                       fmt, int(bool(sort)), int(bool(planes)))
    return out


def bc7_untransform(x: torch.Tensor, n: int, sort: bool, planes: bool) -> torch.Tensor:
    """The transformed bytes of n blocks -> the blocks (uint8[16n])."""
    length = transformed_len(n, sort)
    if x.dtype != torch.uint8 or x.shape != (length,):
        raise ValueError(f"bc7_untransform: expected uint8[{length}] for {n} blocks, "
                         f"got {x.dtype}{tuple(x.shape)}")
    if not backend.dispatch(x):
        return bc7_untransform_plain(x, n, sort, planes)
    backend.require_cuda_tensor(x, "bc7_untransform", torch.uint8, align=4)
    out = torch.empty(BLOCK_SIZE * n, dtype=torch.uint8, device=x.device)
    if n:
        backend.launch("dlt_bc7_untransform", x.device, x.data_ptr(), out.data_ptr(), n,
                       int(bool(sort)), int(bool(planes)))
    return out


def transform_launch_shape(n: int, fmt: int, sort: bool, planes: bool,
                           device: torch.device) -> dict:
    """What ``dlt_bc7_transform`` launches for n blocks on ``device``: its grid (one
    thread block per 4096-block chunk), the blocks the card holds at once, the
    threads of a block and the span. Launches nothing."""
    grid, resident, threads, span = backend.query(
        "dlt_bc7_transform_shape", device, n, fmt, int(bool(sort)), int(bool(planes)))
    return {"grid": grid, "resident": resident, "threads": threads, "span": span}


def untransform_launch_shape(n: int, sort: bool, planes: bool,
                             device: torch.device) -> dict:
    """What ``dlt_bc7_untransform`` launches for n blocks on ``device``: its grid (one
    thread block per span of blocks: a 1024-block tile, or with sorting a 4096-block
    chunk), the blocks the card holds at once, the threads of a block and the span.
    Launches nothing."""
    grid, resident, threads, span = backend.query(
        "dlt_bc7_untransform_shape", device, n, int(bool(sort)), int(bool(planes)))
    return {"grid": grid, "resident": resident, "threads": threads, "span": span}


def deinterleave_words_plain(x: torch.Tensor, k: int) -> tuple:
    return tuple(s.contiguous() for s in x.view(-1, k).unbind(1))


def deinterleave_words(x: torch.Tensor, k: int) -> tuple:
    """int32[k·N] words -> k int32[N] streams, stream i holding words i, i + k, ...
    (each stream a row of one (k, N) tensor)."""
    if k not in (2, 4):
        raise ValueError(f"deinterleave_words: k must be 2 or 4, got {k}")
    if x.dtype != torch.int32 or x.dim() != 1 or x.numel() % k:
        raise ValueError(f"deinterleave_words: expected a 1-D int32 tensor of {k}N words, "
                         f"got {x.dtype} of shape {tuple(x.shape)}")
    if not backend.dispatch(x):
        return deinterleave_words_plain(x, k)
    backend.require_cuda_tensor(x, "deinterleave_words", torch.int32)
    n = x.numel() // k
    out = torch.empty((k, n), dtype=torch.int32, device=x.device)
    if n:
        backend.launch("dlt_deinterleave_words", x.device, x.data_ptr(), out.data_ptr(),
                       n, k)
    return tuple(out.unbind(0))
