"""Host helpers of the corpus batch pipeline: padded bucket sizes and lane splits.

The port's own copy of ``dxt_lossless_transform_tpu/ops/lanes.py`` (``MIN_BUCKET``
:25, ``bucket_size`` :40, ``deinterleave`` :65, ``split_u32`` :111; not
``device_threshold_bytes``: the port batches payloads of every size). Files of one
format are batched by padded block count: a power of two of at least
:data:`MIN_BUCKET` blocks, so that a handful of shapes serves every file size.
"""

from __future__ import annotations

import torch

MIN_BUCKET = 2048


def bucket_size(n: int) -> int:
    """Next power of two >= max(n, MIN_BUCKET)."""
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def deinterleave(x: torch.Tensor, k: int) -> tuple:
    """Split a flat tensor of k interleaved lanes into k contiguous streams:
    ``deinterleave(x, k)[i][j] == x[k*j + i]``."""
    return tuple(s.contiguous() for s in x.reshape(-1, k).unbind(1))


def split_u32(w: torch.Tensor) -> tuple:
    """int32 words -> (lo, hi) 16-bit halves as int32 in [0, 65536)."""
    return w & 0xFFFF, (w >> 16) & 0xFFFF
