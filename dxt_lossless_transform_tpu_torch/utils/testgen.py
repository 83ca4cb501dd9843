"""Deterministic BC1-BC7, BC6H and uncompressed-RGB test data and DDS files.

This package's copy of the BC1-BC7, BC6H and RGB parts of
``dxt_lossless_transform_tpu/utils/testgen.py`` (:25-73, :88-122, :124-212):
the same seeds give the same bytes, which the tests check. ``chip_smoke.py`` uses
it, since it cannot import the JAX package. :func:`mode_sort_edges` is the port's
own: chunks that stress the mode sort's counting sort.
"""

from __future__ import annotations

import struct

import numpy as np

_DDSD_CAPS = 0x1
_DDSD_HEIGHT = 0x2
_DDSD_WIDTH = 0x4
_DDSD_PIXELFORMAT = 0x1000
_DDSD_MIPMAPCOUNT = 0x20000
_DDPF_FOURCC = 0x4
_FOURCC = {"BC1": b"DXT1", "BC2": b"DXT3", "BC3": b"DXT5", "BC4": b"BC4U",
           "BC5": b"ATI2"}
_DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83, "BC6H": 95,
         "BC7": 98}
_BLOCK_SIZE = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16, "BC6H": 16,
               "BC7": 16}


def from_rgb(r, g, b) -> np.ndarray:
    """Pack 8-bit RGB into RGB565 by truncation."""
    r = np.asarray(r, np.uint16)
    g = np.asarray(g, np.uint16)
    b = np.asarray(b, np.uint16)
    return (((r & 0xF8) << 8) | ((g & 0xFC) << 3) | (b >> 3)).astype(np.uint16)


def bc_blocks(num_blocks: int, block_size: int, seed: int = 0) -> bytes:
    """Uniform-random block bytes (worst case: incompressible)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, num_blocks * block_size, dtype=np.uint8).tobytes()


def bc1_realistic(num_blocks: int, seed: int = 0) -> bytes:
    """BC1 blocks with texture-like structure: smoothly varying endpoints, correlated
    RGB channels and a few repeated index patterns."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 8 * np.pi, num_blocks)
    base_r = (96 + 80 * np.sin(t) + rng.normal(0, 8, num_blocks)).clip(0, 255)
    base_g = (base_r * 0.8 + rng.normal(0, 6, num_blocks)).clip(0, 255)
    base_b = (base_r * 0.6 + rng.normal(0, 6, num_blocks)).clip(0, 255)
    c0 = from_rgb(base_r.astype(np.uint8), base_g.astype(np.uint8), base_b.astype(np.uint8))
    delta = rng.integers(0, 24, num_blocks)
    c1 = from_rgb((base_r - delta).clip(0, 255).astype(np.uint8),
                  (base_g - delta).clip(0, 255).astype(np.uint8),
                  (base_b - delta).clip(0, 255).astype(np.uint8))
    patterns = rng.integers(0, 2**32, 8, dtype=np.uint32)
    idx = patterns[rng.integers(0, 8, num_blocks)]
    words = np.empty((num_blocks, 2), dtype="<u4")
    words[:, 0] = c0.astype(np.uint32) | (c1.astype(np.uint32) << 16)
    words[:, 1] = idx
    return words.tobytes()


def bc2_realistic(num_blocks: int, seed: int = 0) -> bytes:
    """BC2 blocks: the colour half of :func:`bc1_realistic`, a few explicit-alpha
    patterns in the lower alpha word and an opaque upper one."""
    rng = np.random.default_rng(seed)
    color_part = np.frombuffer(bc1_realistic(num_blocks, seed), dtype="<u4").reshape(-1, 2)
    words = np.empty((num_blocks, 4), dtype="<u4")
    alpha_patterns = rng.integers(0, 2**32, 4, dtype=np.uint32)
    words[:, 0] = alpha_patterns[rng.integers(0, 4, num_blocks)]
    words[:, 1] = 0xFFFFFFFF
    words[:, 2] = color_part[:, 0]
    words[:, 3] = color_part[:, 1]
    return words.tobytes()


def bc3_realistic(num_blocks: int, seed: int = 0) -> bytes:
    """BC3 blocks: the colour half of :func:`bc1_realistic`, mostly-opaque alpha
    endpoints and a few alpha-index patterns."""
    rng = np.random.default_rng(seed)
    color_part = np.frombuffer(bc1_realistic(num_blocks, seed), dtype="<u4").reshape(-1, 2)
    words = np.empty((num_blocks, 4), dtype="<u4")
    a0 = (200 + rng.normal(0, 20, num_blocks)).clip(0, 255).astype(np.uint32)
    a1 = (a0 - rng.integers(0, 64, num_blocks)).clip(0, 255).astype(np.uint32)
    idx_lo = rng.integers(0, 2**16, num_blocks, dtype=np.uint32)
    words[:, 0] = a0 | (a1 << 8) | (idx_lo << 16)
    words[:, 1] = rng.integers(0, 4, num_blocks, dtype=np.uint32) * 0x49249249
    words[:, 2] = color_part[:, 0]
    words[:, 3] = color_part[:, 1]
    return words.tobytes()


def bc7_realistic(num_blocks: int, seed: int = 0) -> bytes:
    """Mode-clustered BC7 blocks: a mix of modes 4, 5 and 6 in byte 0 and payload
    bytes near a shared base, offset by the mode."""
    rng = np.random.default_rng(seed)
    modes = rng.choice([4, 5, 6], size=num_blocks, p=[0.2, 0.3, 0.5])
    blocks = np.zeros((num_blocks, 16), np.uint8)
    blocks[:, 0] = (1 << modes).astype(np.uint8)
    base = rng.integers(0, 256, 16, np.uint8)
    noise = rng.integers(0, 24, (num_blocks, 16), np.uint8)
    blocks[:, 1:] = (base[None, 1:] + noise[:, 1:]
                     + (modes[:, None] * 31)).astype(np.uint8)
    return blocks.tobytes()


# byte 0 of a block of each mode id (planes.MODE_TABLES maps it back): BC7's 0-7 by
# their trailing zero bits and the invalid 8 by 0; BC6H's 0-1 by the 2-bit modes,
# 2-9 and 10-14 by the 5-bit patterns ending in 10 and 11
MODE_BYTE0 = {"BC7": (1, 2, 4, 8, 16, 32, 64, 128, 0),
              "BC6H": (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19)}
MODE_SORT_EDGES = ("one_mode", "every_id", "descending", "chunk_per_id")
_SORT_CHUNK = 4096


def mode_sort_edges(fmt: str, num_blocks: int, pattern: str, seed: int = 0) -> bytes:
    """Random ``fmt`` (BC7 or BC6H) blocks whose byte 0 gives each the mode id of
    ``pattern``, over the mode sort's 4096-block chunks: one id throughout
    (``one_mode``), every id in turn (``every_id``), ids descending over each chunk
    (``descending``), or chunk c all of id c (``chunk_per_id``; at ``len(ids) *
    4096 + 1`` blocks the ragged last chunk holds a single block)."""
    byte0 = np.array(MODE_BYTE0[fmt], np.uint8)
    k = len(byte0)
    i = np.arange(num_blocks)
    ids = {"one_mode": np.full(num_blocks, k // 2),
           "every_id": i % k,
           "descending": k - 1 - (i % _SORT_CHUNK) * k // _SORT_CHUNK,
           "chunk_per_id": (i // _SORT_CHUNK) % k}[pattern]
    blocks = np.random.default_rng(seed).integers(0, 256, (num_blocks, 16), np.uint8)
    blocks[:, 0] = byte0[ids]
    return blocks.tobytes()


# BC4 and BC5 payloads are uniform-random blocks and BC6H's are BC7's, as in the
# reference
_REALISTIC = {"BC1": bc1_realistic, "BC2": bc2_realistic, "BC3": bc3_realistic,
              "BC4": lambda n, seed: bc_blocks(n, 8, seed),
              "BC5": lambda n, seed: bc_blocks(n, 16, seed),
              "BC6H": bc7_realistic, "BC7": bc7_realistic}


def _check_format(fmt: str, formats=_FOURCC) -> None:
    if fmt not in formats:
        raise ValueError(f"unsupported synthetic format {fmt}: this package makes "
                         f"{', '.join(formats)}")


def _chain_blocks(width: int, height: int, mipmaps: int) -> int:
    total, w, h = 0, width, height
    for _ in range(mipmaps):
        total += ((w + 3) // 4) * ((h + 3) // 4)
        w, h = max(w // 2, 1), max(h // 2, 1)
    return total


def chain_blocks(width: int, height: int) -> int:
    """Blocks of a full mip chain (every level down to 1x1) of a width x height
    texture."""
    return _chain_blocks(width, height, max(width, height).bit_length())


def _flags(mipmaps: int) -> int:
    flags = _DDSD_CAPS | _DDSD_HEIGHT | _DDSD_WIDTH | _DDSD_PIXELFORMAT
    return flags | (_DDSD_MIPMAPCOUNT if mipmaps > 1 else 0)


def make_dds(fmt: str, width: int, height: int, mipmaps: int = 1, seed: int = 0,
             realistic: bool = True, trailing: bytes = b"") -> bytes:
    """A legacy-header BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4 (BC4U) or BC5 (ATI2)
    DDS file whose payload covers the whole mip chain."""
    _check_format(fmt)
    n = _chain_blocks(width, height, mipmaps)
    payload = (_REALISTIC[fmt](n, seed) if realistic
               else bc_blocks(n, _BLOCK_SIZE[fmt], seed))
    header = bytearray(128)
    header[0:4] = b"DDS "
    struct.pack_into("<7I", header, 4, 124, _flags(mipmaps), height, width, 0, 0, mipmaps)
    struct.pack_into("<2I", header, 0x4C, 32, _DDPF_FOURCC)
    header[0x54:0x58] = _FOURCC[fmt]
    struct.pack_into("<I", header, 0x6C, 0x1000)  # caps: DDSCAPS_TEXTURE
    return bytes(header) + payload + trailing


def make_dx10_dds(fmt: str, width: int, height: int, mipmaps: int = 1,
                  seed: int = 0, trailing: bytes = b"",
                  payload: bytes = None) -> bytes:
    """A DX10-header BC1-BC7 or BC6H DDS file (payload at 0x94), the only container
    form of BC6H and BC7."""
    _check_format(fmt, _DXGI)
    n = _chain_blocks(width, height, mipmaps)
    if payload is None:
        payload = _REALISTIC[fmt](n, seed)
    elif len(payload) != n * _BLOCK_SIZE[fmt]:
        raise ValueError(f"payload is {len(payload)} bytes; the stated "
                         f"{width}x{height}x{mipmaps} chain needs "
                         f"{n * _BLOCK_SIZE[fmt]}")
    header = bytearray(0x94)
    header[0:4] = b"DDS "
    struct.pack_into("<7I", header, 4, 124, _flags(mipmaps), height, width, 0, 0, mipmaps)
    struct.pack_into("<2I", header, 0x4C, 32, _DDPF_FOURCC)
    header[0x54:0x58] = b"DX10"
    # dxgiFormat, resourceDimension=3 (2D), miscFlag, arraySize, miscFlags2
    struct.pack_into("<5I", header, 0x80, _DXGI[fmt], 3, 0, 1, 0)
    struct.pack_into("<I", header, 0x6C, 0x1000)
    return bytes(header) + payload + trailing


# pixel layout -> (bits per pixel, R, G, B and A masks)
_RGB_MASKS = {"rgba8888": (32, (0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000)),
              "bgra8888": (32, (0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)),
              "bgr888": (24, (0x00FF0000, 0x0000FF00, 0x000000FF, 0))}


def make_uncompressed_dds(layout: str, width: int, height: int,
                          seed: int = 0) -> bytes:
    """A legacy-header uncompressed DDS file of one level, detected by its channel
    masks: ``layout`` is ``"rgba8888"``, ``"bgra8888"`` or ``"bgr888"``. Its pixels
    are a vertical gradient with noise around a random base colour, alpha 255."""
    bit_count, masks = _RGB_MASKS[layout]
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, 3)
    px = np.empty((height, width, bit_count // 8), np.uint8)
    yy = np.linspace(0, 40, height)[:, None]
    for c in range(3):
        px[..., c] = np.clip(base[c] + yy + rng.normal(0, 3, (height, width)),
                             0, 255).astype(np.uint8)
    if bit_count == 32:
        px[..., 3] = 255
    header = bytearray(0x80)
    header[0:4] = b"DDS "
    # 0x100F = CAPS | HEIGHT | WIDTH | PITCH | PIXELFORMAT, with the pitch written
    struct.pack_into("<7I", header, 4, 124, 0x100F, height, width,
                     width * (bit_count // 8), 0, 1)
    flags = 0x40 | (0x1 if masks[3] else 0)  # DDPF_RGB, with ALPHAPIXELS for alpha
    struct.pack_into("<3I", header, 0x4C, 32, flags, 0)
    struct.pack_into("<I", header, 0x58, bit_count)
    struct.pack_into("<4I", header, 0x5C, *masks)
    struct.pack_into("<I", header, 0x6C, 0x1000)
    return bytes(header) + px.tobytes()
