"""RGB565 color lane math (numpy, vectorized); the port's copy of
``dxt_lossless_transform_tpu/oracle/color565.py``.

Behavioral reference: ``dxt-lossless-transform-common/src/color_565/mod.rs:88-253``.
All functions operate elementwise on numpy integer arrays; 16-bit color values are
carried in int64/int32-safe arrays and masked explicitly so results are bit-exact.
"""

from __future__ import annotations

import numpy as np


def from_rgb(r, g, b) -> np.ndarray:
    """Pack 8-bit RGB into RGB565 (etcpak-style truncation; mod.rs:108-128)."""
    r = np.asarray(r, np.uint16)
    g = np.asarray(g, np.uint16)
    b = np.asarray(b, np.uint16)
    return (((r & 0xF8) << 8) | ((g & 0xFC) << 3) | (b >> 3)).astype(np.uint16)


def expand_red(c) -> np.ndarray:
    """Expanded 8-bit red via D3D11 bit-replication: (r5<<3)|(r5>>2) (mod.rs:154-160)."""
    c = np.asarray(c, np.int64)
    r = (c >> 11) & 0x1F
    return ((r << 3) | (r >> 2)).astype(np.uint8)


def expand_green(c) -> np.ndarray:
    """Expanded 8-bit green via (g6<<2)|(g6>>4) (mod.rs:171-177)."""
    c = np.asarray(c, np.int64)
    g = (c >> 5) & 0x3F
    return ((g << 2) | (g >> 4)).astype(np.uint8)


def expand_blue(c) -> np.ndarray:
    """Expanded 8-bit blue via (b5<<3)|(b5>>2) (mod.rs:185-191)."""
    c = np.asarray(c, np.int64)
    b = c & 0x1F
    return ((b << 3) | (b >> 2)).astype(np.uint8)


def to_rgba8888(c, alpha=255):
    """Expand RGB565 lanes to an (..., 4) uint8 RGBA array."""
    c = np.asarray(c)
    out = np.empty(c.shape + (4,), np.uint8)
    out[..., 0] = expand_red(c)
    out[..., 1] = expand_green(c)
    out[..., 2] = expand_blue(c)
    out[..., 3] = alpha
    return out
