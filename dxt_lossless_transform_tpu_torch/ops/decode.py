"""BC1/BC2/BC3 block decoders on the device, in plain PyTorch (counterpart of
``dxt_lossless_transform_tpu/ops/decode.py:65-124``, which is ``jnp`` with no Pallas
kernel), and the RGB565 colour helpers that normalization needs (the torch twins of
:mod:`..oracle.color565`).

The same 'ideal' D3D9 rounding as :mod:`..oracle.decode`: endpoints expanded 5/6 to 8
bits by bit replication, then interpolated in integer math (BC1 four colours when
``c0 > c1`` as unsigned 16-bit values, else three and transparent black; BC2 and BC3
always four; BC2 alpha the 4-bit field times 17; BC3 alpha the 8-entry BC4-style
table). Input is a words tensor, ``int32`` of shape ``(N, 2)`` (BC1) or ``(N, 4)``
(BC2, BC3) on any device, each word a little-endian u32 of the block; output is
``(4, N, 16)`` ``int32`` RGBA planes in raster order, as in JAX. torch has no full
``uint32`` arithmetic and ``>>`` of a negative ``int32`` brings in copies of the sign
bit, so every shift is masked to the bits it takes, and BC3's 48-bit selector field,
which crosses the word boundary, is assembled in ``int64``. The ``*_bytes`` entry
points copy a payload to ``device`` once and decode it there.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import backend


def expand565(c: torch.Tensor) -> tuple:
    """RGB565 values (ints in [0, 65536)) -> their (r, g, b) 8-bit channels by bit
    replication, as int32."""
    c = c.to(torch.int32)
    r5 = (c >> 11) & 0x1F
    g6 = (c >> 5) & 0x3F
    b5 = c & 0x1F
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)


def from_rgb(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """8-bit channels -> RGB565 by truncation, as int32 in [0, 65536)
    (:func:`..oracle.color565.from_rgb`)."""
    return ((r & 0xF8) << 8) | ((g & 0xFC) << 3) | (b >> 3)


def to_rgba8888(c: torch.Tensor, alpha: int = 255) -> torch.Tensor:
    """RGB565 values -> an (..., 4) int32 RGBA tensor
    (:func:`..oracle.color565.to_rgba8888`)."""
    r, g, b = expand565(c)
    return torch.stack([r, g, b, torch.full_like(r, alpha)], dim=-1)


def _lut4(c0: torch.Tensor, c1: torch.Tensor, always_four: bool) -> tuple:
    """Each block's 4-entry colour table: ((3, N, 4) RGB, (N, 4) alpha), int32."""
    r0, g0, b0 = expand565(c0)
    r1, g1, b1 = expand565(c1)
    is4 = None if always_four else c0 > c1
    rgb = []
    for a, b in ((r0, r1), (g0, g1), (b0, b1)):
        e2, e3 = (2 * a + b) // 3, (a + 2 * b) // 3
        if is4 is not None:
            e2 = torch.where(is4, e2, (a + b) // 2)
            e3 = torch.where(is4, e3, 0)
        rgb.append(torch.stack([a, b, e2, e3], dim=-1))
    opaque = torch.full_like(r0, 255)
    alpha3 = opaque if is4 is None else torch.where(is4, 255, 0).to(torch.int32)
    return torch.stack(rgb), torch.stack([opaque, opaque, opaque, alpha3], dim=-1)


def _color_planes(colours: torch.Tensor, indices: torch.Tensor,
                  always_four: bool) -> list:
    """The four RGBA planes (N, 16) of the colour section: the word of both
    endpoints and the word of 2-bit indices."""
    c0 = colours & 0xFFFF
    c1 = (colours >> 16) & 0xFFFF
    lut_rgb, lut_a = _lut4(c0, c1, always_four)
    shifts = 2 * torch.arange(16, device=colours.device, dtype=torch.int32)
    sel = ((indices[:, None] >> shifts) & 3).to(torch.int64)
    planes = [torch.gather(lut_rgb[ch], 1, sel) for ch in range(3)]
    planes.append(torch.gather(lut_a, 1, sel))
    return planes


def decode_bc1(words: torch.Tensor) -> torch.Tensor:
    """int32[N, 2] block words -> (4, N, 16) int32 RGBA planes."""
    return torch.stack(_color_planes(words[:, 0], words[:, 1], always_four=False))


def decode_bc2(words: torch.Tensor) -> torch.Tensor:
    """int32[N, 4] block words -> (4, N, 16) int32 RGBA planes."""
    r, g, b, _ = _color_planes(words[:, 2], words[:, 3], always_four=True)
    shifts = 4 * torch.arange(8, device=words.device, dtype=torch.int32)
    a4 = torch.cat([(words[:, 0:1] >> shifts) & 0xF, (words[:, 1:2] >> shifts) & 0xF],
                   dim=1)
    return torch.stack([r, g, b, a4 * 17])


def decode_bc3(words: torch.Tensor) -> torch.Tensor:
    """int32[N, 4] block words -> (4, N, 16) int32 RGBA planes."""
    r, g, b, _ = _color_planes(words[:, 2], words[:, 3], always_four=True)
    w0 = words[:, 0].to(torch.int64) & 0xFFFFFFFF
    w1 = words[:, 1].to(torch.int64) & 0xFFFFFFFF
    a0 = (w0 & 0xFF).to(torch.int32)
    a1 = ((w0 >> 8) & 0xFF).to(torch.int32)
    seven = a0 > a1
    codes = [a0, a1]
    for code in range(2, 8):
        w = code - 1
        i7 = ((8 - code) * a0 + w * a1) // 7
        if code < 6:
            i5 = ((6 - code) * a0 + w * a1) // 5
        else:
            i5 = torch.full_like(a0, 0 if code == 6 else 255)
        codes.append(torch.where(seven, i7, i5))
    lut = torch.stack(codes, dim=-1)
    # the 48-bit selector field: bits 16-31 of w0, then w1; 3 bits a pixel
    field = (w0 >> 16) | (w1 << 16)
    shifts = 3 * torch.arange(16, device=words.device, dtype=torch.int64)
    sel = (field[:, None] >> shifts) & 7
    return torch.stack([r, g, b, torch.gather(lut, 1, sel)])


def words(x: torch.Tensor, cols: int) -> torch.Tensor:
    """A uint8 tensor of whole blocks as its (N, cols) int32 words (a view)."""
    if not x.numel():
        return torch.zeros((0, cols), dtype=torch.int32, device=x.device)
    return x.view(torch.int32).view(-1, cols)


def _decode_bytes(data, block_size: int, decoder, device) -> torch.Tensor:
    if len(data) % block_size:
        raise ValueError(f"data length {len(data)} is not a multiple of the "
                         f"{block_size}-byte block")
    x = backend.upload(data, backend.resolve_device(device))
    return decoder(words(x, block_size // 4))


def decode_bc1_bytes(data, device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """BC1 bytes, copied to ``device`` once -> (4, N, 16) int32 RGBA planes there."""
    return _decode_bytes(data, 8, decode_bc1, device)


def decode_bc2_bytes(data, device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """BC2 bytes, copied to ``device`` once -> (4, N, 16) int32 RGBA planes there."""
    return _decode_bytes(data, 16, decode_bc2, device)


def decode_bc3_bytes(data, device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """BC3 bytes, copied to ``device`` once -> (4, N, 16) int32 RGBA planes there."""
    return _decode_bytes(data, 16, decode_bc3, device)
