"""BC1/BC2/BC3 block decoders to RGBA8888 (numpy, vectorized over blocks); the port's
copy of ``dxt_lossless_transform_tpu/oracle/decode.py``.

'Ideal' D3D9-style rounding, matching the reference decoders
(``bc1/src/util/bc1_decode.rs:42-103``, ``bc2/src/util/bc2_decode.rs:44-125``,
``bc3/src/util/bc3_decode.rs:40-175``). Endpoints are first expanded 5/6->8 bit by
bit-replication per the D3D11 functional spec, then interpolated in integer math:

- BC1: 4-color mode when c0 > c1 ((2a+b)/3), else 3-color + transparent-black mode ((a+b)/2).
- BC2/BC3: color section always decodes in 4-color mode; alpha comes from the explicit
  4-bit field (BC2, scaled x17) or the BC4-style interpolated alpha block (BC3).

These decoders are the ground truth for "visually lossless" checks (normalization) and
stand in for the reference's rgbcx fuzz oracle.

Output shape: (N, 4, 4, 4) uint8 -- (block, y, x, RGBA).
"""

from __future__ import annotations

import numpy as np

from . import color565


def _color_dict_4(c0: np.ndarray, c1: np.ndarray, always_four: bool):
    """Build the 4-entry color LUT per block. Returns (dict_rgb (N,4,3) uint8, dict_a (N,4) uint8)."""
    n = len(c0)
    r0 = color565.expand_red(c0).astype(np.uint32)
    g0 = color565.expand_green(c0).astype(np.uint32)
    b0 = color565.expand_blue(c0).astype(np.uint32)
    r1 = color565.expand_red(c1).astype(np.uint32)
    g1 = color565.expand_green(c1).astype(np.uint32)
    b1 = color565.expand_blue(c1).astype(np.uint32)

    rgb = np.zeros((n, 4, 3), np.uint32)
    a = np.full((n, 4), 255, np.uint8)
    rgb[:, 0] = np.stack([r0, g0, b0], -1)
    rgb[:, 1] = np.stack([r1, g1, b1], -1)

    four_2 = np.stack([(2 * r0 + r1) // 3, (2 * g0 + g1) // 3, (2 * b0 + b1) // 3], -1)
    four_3 = np.stack([(r0 + 2 * r1) // 3, (g0 + 2 * g1) // 3, (b0 + 2 * b1) // 3], -1)
    if always_four:
        rgb[:, 2] = four_2
        rgb[:, 3] = four_3
    else:
        three_2 = np.stack([(r0 + r1) // 2, (g0 + g1) // 2, (b0 + b1) // 2], -1)
        is_four = (np.asarray(c0, np.uint32) > np.asarray(c1, np.uint32))[:, None]
        rgb[:, 2] = np.where(is_four, four_2, three_2)
        rgb[:, 3] = np.where(is_four, four_3, 0)
        a[:, 3] = np.where(is_four[:, 0], 255, 0).astype(np.uint8)
    return rgb.astype(np.uint8), a


def _gather_color_pixels(dict_rgb, dict_a, idx_u32):
    """Expand 2-bit indices and gather the LUT. Returns (N,16,4) uint8 RGBA in raster order."""
    n = len(idx_u32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    sel = (np.asarray(idx_u32, np.uint32)[:, None] >> shifts) & 0x3
    rows = np.arange(n)[:, None]
    out = np.empty((n, 16, 4), np.uint8)
    out[..., :3] = dict_rgb[rows, sel]
    out[..., 3] = dict_a[rows, sel]
    return out


def decode_bc1(data) -> np.ndarray:
    """Decode BC1 bytes to (N,4,4,4) uint8 RGBA."""
    words = np.frombuffer(data, dtype="<u4").reshape(-1, 2)
    c0 = (words[:, 0] & 0xFFFF).astype(np.uint16)
    c1 = (words[:, 0] >> 16).astype(np.uint16)
    dict_rgb, dict_a = _color_dict_4(c0, c1, always_four=False)
    return _gather_color_pixels(dict_rgb, dict_a, words[:, 1]).reshape(-1, 4, 4, 4)


def decode_bc2(data) -> np.ndarray:
    """Decode BC2 bytes to (N,4,4,4) uint8 RGBA (explicit 4-bit alpha, scaled x17)."""
    words = np.frombuffer(data, dtype="<u4").reshape(-1, 4)
    alpha = words[:, 0].astype(np.uint64) | (words[:, 1].astype(np.uint64) << np.uint64(32))
    c0 = (words[:, 2] & 0xFFFF).astype(np.uint16)
    c1 = (words[:, 2] >> 16).astype(np.uint16)
    dict_rgb, dict_a = _color_dict_4(c0, c1, always_four=True)
    out = _gather_color_pixels(dict_rgb, dict_a, words[:, 3])
    shifts = (4 * np.arange(16, dtype=np.uint64))[None, :]
    a4 = ((alpha[:, None] >> shifts) & np.uint64(0xF)).astype(np.uint32)
    out[..., 3] = (a4 * 17).astype(np.uint8)
    return out.reshape(-1, 4, 4, 4)


def decode_bc3(data) -> np.ndarray:
    """Decode BC3 bytes to (N,4,4,4) uint8 RGBA (BC4-style interpolated alpha)."""
    words = np.frombuffer(data, dtype="<u4").reshape(-1, 4)
    n = len(words)
    a0 = (words[:, 0] & 0xFF).astype(np.uint32)
    a1 = ((words[:, 0] >> 8) & 0xFF).astype(np.uint32)
    # 48-bit alpha index field: bytes 2..8 of the block, little-endian
    aidx = ((words[:, 0].astype(np.uint64) >> np.uint64(16))
            | (words[:, 1].astype(np.uint64) << np.uint64(16)))
    c0 = (words[:, 2] & 0xFFFF).astype(np.uint16)
    c1 = (words[:, 2] >> 16).astype(np.uint16)

    dict_rgb, dict_a = _color_dict_4(c0, c1, always_four=True)
    out = _gather_color_pixels(dict_rgb, dict_a, words[:, 3])

    # Alpha LUT per block: 8 entries, mode chosen by a0 > a1
    lut = np.zeros((n, 8), np.uint32)
    lut[:, 0] = a0
    lut[:, 1] = a1
    seven = a0 > a1
    for code in range(2, 8):
        w = code - 1
        interp7 = ((8 - code) * a0 + w * a1) // 7     # ((7-w)*a0 + w*a1)/7
        if code < 6:
            interp5 = ((6 - code) * a0 + w * a1) // 5
        else:
            interp5 = np.full_like(a0, 0 if code == 6 else 255)
        lut[:, code] = np.where(seven, interp7, interp5)

    shifts = (3 * np.arange(16, dtype=np.uint64))[None, :]
    sel = ((aidx[:, None] >> shifts) & np.uint64(0x7)).astype(np.int64)
    out[..., 3] = lut[np.arange(n)[:, None], sel].astype(np.uint8)
    return out.reshape(-1, 4, 4, 4)
