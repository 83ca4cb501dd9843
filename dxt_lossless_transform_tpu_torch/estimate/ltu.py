"""LTU estimator: sampled-offset 4-gram coverage plus a prefix entropy term.

Counterpart of ``dxt_lossless_transform_tpu/estimate/ltu.py:33-216``. A position is
covered when its 4-byte gram equals the gram at one of a fixed ladder of backward
offsets, and is worth more the nearer its nearest match:

    score = 24 * valid_len - sum_i W(min k : gram4[i] == gram4[i - k]) + ENT
    W(k)  = 24 - round(log2 k)
    ENT   = 3 * max(0, G[N] - sum_c G[hist_c]) // 8,   N = min(valid_len, 65536)

where hist is the byte histogram of the first N bytes. Every term is an integer and
the port sums exactly in int64 at every size, like the reference's numpy and C++
scorers; the JAX device scorer sums in f32 and agrees with them only while the
weighted total is below 2**24.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from .. import backend
from .base import SizeEstimation
from .cuda_ltu import ValidLen, byte_rows, device_lengths, ltu_counts
from .gtable import ENTROPY_CAP, G_TABLE

DEFAULT_OFFSETS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256,
                   512, 1024, 2048, 4096)

WEIGHT_SCALE = 24


def offset_weight(k: int) -> int:
    """Integer value of a position whose nearest match is at offset k."""
    return WEIGHT_SCALE - (int(round(math.log2(k))) if k > 1 else 0)


_G_TABLES: dict = {}


def _g_table(device: torch.device) -> torch.Tensor:
    """:data:`G_TABLE` on ``device``, copied there once."""
    if device not in _G_TABLES:
        _G_TABLES[device] = torch.from_numpy(G_TABLE).to(device)
    return _G_TABLES[device]


def entropy_terms(rows: torch.Tensor, valid_len: ValidLen,
                  longest: Optional[int] = None) -> torch.Tensor:
    """Prefix entropy term of each (C, L) uint8 row, as int64 (C,). ``valid_len`` is
    one length or a (C,) tensor of lengths (with ``longest``, their largest, where
    they lie on the device); row r's prefix is its first
    ``min(valid_len[r], ENTROPY_CAP)`` bytes, and no byte past it reaches the
    histogram."""
    c = rows.shape[0]
    g = _g_table(rows.device)
    bins = torch.arange(c, device=rows.device, dtype=torch.int64)[:, None] * 256
    if not isinstance(valid_len, torch.Tensor):
        n = min(valid_len, ENTROPY_CAP)
        if n <= 1:
            return torch.zeros(c, dtype=torch.int64, device=rows.device)
        sample = rows[:, :n].to(torch.int64) + bins
        hist = torch.bincount(sample.reshape(-1), minlength=256 * c).view(c, 256)
        raw = g[n] - g[hist].sum(dim=1)
        return 3 * raw.clamp(min=0) // 8
    n = prefix_lengths(valid_len, rows.device)
    if longest is None:
        longest = int(valid_len.max()) if c else 0
    return entropy_from_histograms(prefix_histograms(rows, n, min(longest, ENTROPY_CAP)), n)


def prefix_lengths(valid_len: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Each row's entropy prefix, ``min(valid_len, ENTROPY_CAP)``, on ``device``."""
    return valid_len.to(device, torch.int64, non_blocking=True).clamp(max=ENTROPY_CAP)


def prefix_histograms(rows: torch.Tensor, n: torch.Tensor, longest: int,
                      start: int = 0) -> torch.Tensor:
    """(C, 256) int64 byte histograms of the (C, L) uint8 rows, which hold the bytes
    at positions ``start`` .. ``start`` + L of their rows: of each row, the bytes at
    positions below its prefix length ``n`` (a (C,) tensor on the rows' device; the
    largest at most ``longest``). Histograms of a row's pieces sum to the whole
    row's."""
    c = rows.shape[0]
    width = max(0, min(longest - start, rows.shape[1]))
    bins = torch.arange(c, device=rows.device, dtype=torch.int64)[:, None] * 256
    # bytes past a row's prefix go to one spare bin after the C * 256 real ones;
    # a sum into a histogram of known size, where bincount would read the largest
    # bin number back to the host first
    inside = torch.arange(start, start + width, device=rows.device) < n[:, None]
    sample = torch.where(inside, rows[:, :width].to(torch.int64) + bins, 256 * c)
    hist = torch.zeros(256 * c + 1, dtype=torch.int64, device=rows.device).scatter_add_(
        0, sample.reshape(-1), torch.ones(sample.numel(), dtype=torch.int64,
                                          device=rows.device))
    return hist[:256 * c].view(c, 256)


def entropy_from_histograms(hist: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The entropy term of rows whose prefixes of lengths ``n`` (C,) have the byte
    histograms ``hist`` (C, 256), as int64 (C,)."""
    g = _g_table(hist.device)
    raw = g[n] - g[hist].sum(dim=1)
    return torch.where(n > 1, 3 * raw.clamp(min=0) // 8, 0)


def coverage_scores(rows: torch.Tensor, valid_len: ValidLen,
                    offsets: Sequence[int] = DEFAULT_OFFSETS) -> torch.Tensor:
    """Scores of (C, L) uint8 rows (or (C, L/4) int32 words), of which the first
    ``valid_len`` bytes are real (one length, or a (C,) tensor of one per row, on the
    host), as exact int64 (C,). Lower is better."""
    rows = byte_rows(rows)
    ks = sorted(set(int(k) for k in offsets))
    ws = [offset_weight(k) for k in ks]
    if isinstance(valid_len, torch.Tensor):
        # one copy of the lengths to the rows' device serves every term
        lengths = device_lengths(valid_len, rows.device)
        return (WEIGHT_SCALE * lengths.lengths - ltu_counts(rows, lengths, ks, ws)
                + entropy_terms(rows, lengths.lengths, lengths.longest))
    return (WEIGHT_SCALE * valid_len - ltu_counts(rows, valid_len, ks, ws)
            + entropy_terms(rows, valid_len))


class LtuEstimation(SizeEstimation):
    """Length minus sampled-offset gram-match coverage, plus the entropy term.

    :meth:`estimate_batch_device` scores a region tensor on the device it lies on;
    :meth:`estimate` copies one buffer to ``device`` first."""

    def __init__(self, offsets=DEFAULT_OFFSETS):
        self.offsets = tuple(offsets)

    def max_compressed_size(self, len_bytes: int) -> int:
        return 0  # no compression buffer needed

    def estimate(self, data, device: Union[str, torch.device] = "cuda") -> int:
        rows = backend.upload(data, backend.resolve_device(device))[None, :]
        return int(coverage_scores(rows, rows.shape[1], self.offsets)[0])

    def estimate_batch_device(self, regions: torch.Tensor,
                              valid_len: ValidLen) -> torch.Tensor:
        return coverage_scores(regions, valid_len, self.offsets)
