"""Plain PyTorch arithmetic shared by the BC1 and BC3 references: the YCoCg-R colour
decorrelation and the exact LTU size estimate.

Written from the published description of the transform (upstream
``dxt-lossless-transform-common/src/color_565/decorrelate.rs``) and of the LTU
estimator, with no code of the package under test. Every value is an int64 tensor on
whatever device the caller's bytes lie, so the same code runs in the CPU tests and on
the card after a run's window.

LTU score of a byte row of ``valid`` real bytes (lower is better)::

    score = 24 * valid - sum_i W(min k : gram(i) == gram(i - k), k <= i) + ENT
    W(k)  = 24 - round(log2 k)   (W(1) = 24)
    ENT   = 3 * max(0, G[m] - sum_c G[hist_c]) // 8,   m = min(valid, 65536)

over positions i < valid - 3, with gram(i) the four bytes at i, the offsets k from
:data:`OFFSETS`, hist the byte histogram of the first m bytes (ENT is 0 for m <= 1)
and G[x] = floor(x log2 x + 0.5).
"""

from __future__ import annotations

import math

import numpy as np
import torch

OFFSETS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1024,
           2048, 4096)
WEIGHT_SCALE = 24
ENTROPY_CAP = 65536

_M5 = 0x1F


def weight(k: int) -> int:
    return WEIGHT_SCALE - (int(round(math.log2(k))) if k > 1 else 0)


def g_table() -> np.ndarray:
    g = np.zeros(ENTROPY_CAP + 1, np.int64)
    x = np.arange(2, ENTROPY_CAP + 1, dtype=np.float64)
    g[2:] = np.floor(x * np.log2(x) + 0.5).astype(np.int64)
    return g


_G = g_table()


# --- YCoCg-R on 16-bit RGB565 values -------------------------------------------------

def _forward(r, g, b):
    co = (r - b) & _M5
    t = (b + (co >> 1)) & _M5
    cg = (g - t) & _M5
    y = (t + (cg >> 1)) & _M5
    return y, co, cg


def _inverse(y, co, cg):
    t = (y - (cg >> 1)) & _M5
    g = (cg + t) & _M5
    b = (t - (co >> 1)) & _M5
    r = (b + co) & _M5
    return r, g, b


def decorrelate(c: torch.Tensor, variant: int) -> torch.Tensor:
    """RGB565 values (int64) -> their YCoCg-R form under ``variant`` (0 = none,
    1: [Y|Co|g_low|Cg], 2: [g_low|Y|Co|Cg], 3: [Y|Co|Cg|g_low])."""
    if variant == 0:
        return c
    r, g, g_low, b = (c >> 11) & _M5, (c >> 6) & _M5, (c >> 5) & 1, c & _M5
    y, co, cg = _forward(r, g, b)
    if variant == 1:
        return (y << 11) | (co << 6) | (g_low << 5) | cg
    if variant == 2:
        return (g_low << 15) | (y << 10) | (co << 5) | cg
    if variant == 3:
        return (y << 11) | (co << 6) | (cg << 1) | g_low
    raise ValueError(f"no YCoCg variant {variant}")


def recorrelate(c: torch.Tensor, variant: int) -> torch.Tensor:
    """Inverse of :func:`decorrelate`."""
    if variant == 0:
        return c
    if variant == 1:
        y, co, g_low, cg = (c >> 11) & _M5, (c >> 6) & _M5, (c >> 5) & 1, c & _M5
    elif variant == 2:
        g_low, y, co, cg = (c >> 15) & 1, (c >> 10) & _M5, (c >> 5) & _M5, c & _M5
    elif variant == 3:
        y, co, cg, g_low = (c >> 11) & _M5, (c >> 6) & _M5, (c >> 1) & _M5, c & 1
    else:
        raise ValueError(f"no YCoCg variant {variant}")
    r, g, b = _inverse(y, co, cg)
    return (r << 11) | (g << 6) | (g_low << 5) | b


# --- little-endian lanes ---------------------------------------------------------------

def lanes(data: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """(n * count * width) uint8 bytes -> (n, count) int64 little-endian values of
    ``width`` bytes each."""
    b = data.view(-1, count, width).to(torch.int64)
    out = b[..., 0].clone()
    for j in range(1, width):
        out |= b[..., j] << (8 * j)
    return out


def to_bytes(values: torch.Tensor, width: int) -> torch.Tensor:
    """int64 values -> their ``width``-byte little-endian bytes, flattened, uint8."""
    return torch.stack([(values >> (8 * j)) & 0xFF for j in range(width)],
                       dim=-1).to(torch.uint8).reshape(-1)


# --- the LTU estimate -----------------------------------------------------------------

def _grams(row: torch.Tensor, valid: int) -> torch.Tensor:
    b = row[:valid].to(torch.int64)
    m = valid - 3
    return b[:m] | (b[1:m + 1] << 8) | (b[2:m + 2] << 16) | (b[3:m + 3] << 24)


def nearest_match(row: torch.Tensor, valid: int) -> tuple:
    """(weights, compares) of each position i < valid - 3 of ``row``: the weight of
    its nearest matching offset (0 without one), and how many gram compares the
    ascending ladder needs to find it (every offset k <= i where none matches)."""
    m = valid - 3
    if m <= 0:
        z = torch.zeros(0, dtype=torch.int64, device=row.device)
        return z, z
    g = _grams(row, valid)
    w = torch.zeros(m, dtype=torch.int64, device=row.device)
    ks = torch.tensor(OFFSETS, device=row.device)
    compares = torch.bucketize(torch.arange(m, device=row.device), ks, right=True)
    for o in reversed(range(len(OFFSETS))):  # the nearest match is written last
        k = OFFSETS[o]
        if k >= m:
            continue
        hit = g[k:] == g[:-k]
        w[k:] = torch.where(hit, torch.tensor(weight(k), dtype=torch.int64,
                                              device=row.device), w[k:])
        compares[k:] = torch.where(hit, o + 1, compares[k:])
    return w, compares


def entropy_term(row: torch.Tensor, valid: int) -> int:
    m = min(valid, ENTROPY_CAP)
    if m <= 1:
        return 0
    hist = torch.bincount(row[:m].to(torch.int64), minlength=256).cpu().numpy()
    return 3 * max(0, int(_G[m]) - int(_G[hist].sum())) // 8


def ltu_score(row: torch.Tensor, valid: int) -> int:
    """The exact LTU score of the first ``valid`` bytes of the uint8 ``row``."""
    w, _ = nearest_match(row, valid)
    return WEIGHT_SCALE * valid - int(w.sum()) + entropy_term(row, valid)


def compares_needed(row: torch.Tensor, valid: int) -> int:
    """Gram compares the ascending ladder needs over the first ``valid`` bytes of
    ``row``: the count kernel's data-dependent work."""
    return int(nearest_match(row, valid)[1].sum())
