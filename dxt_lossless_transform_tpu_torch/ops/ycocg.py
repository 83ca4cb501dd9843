"""YCoCg-R decorrelation of RGB565 values as plain PyTorch integer ops.

Counterpart of ``dxt_lossless_transform_tpu/ops/ycocg.py`` (the variants at :17-95
and the pair forms at :98-154). Values are 16-bit colours held in int32; a pair is a
colour word ``c0 | c1 << 16`` held in int32, so bit 31 is the sign bit. PyTorch for
the CPU implements no shifts or arithmetic on ``torch.uint32``, so every right shift
here is followed by a mask that makes it a logical one.

The lifting scheme on the three 5-bit fields (the green low bit rides along):

    forward:  Co = R - B;  t = B + (Co >> 1);  Cg = G - t;  Y = t + (Cg >> 1)
    inverse:  t = Y - (Cg >> 1);  G = Cg + t;  B = t - (Co >> 1);  R = B + Co

The variants differ only in where (Y, Co, Cg, g_low) sit in the 16 bits:
var1 ``[Y|Co|g_low|Cg]``, var2 ``[g_low|Y|Co|Cg]``, var3 ``[Y|Co|Cg|g_low]``.
"""

from __future__ import annotations

import torch

_M5 = 0x1F


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


def _rgb_fields(c):
    return (c >> 11) & _M5, (c >> 6) & _M5, (c >> 5) & 0x1, c & _M5


def _pack_rgb(r, g, g_low, b):
    return (r << 11) | (g << 6) | (g_low << 5) | b


def decorrelate_var1(c):
    r, g, g_low, b = _rgb_fields(c)
    y, co, cg = _forward(r, g, b)
    return (y << 11) | (co << 6) | (g_low << 5) | cg


def recorrelate_var1(c):
    y, co, g_low, cg = (c >> 11) & _M5, (c >> 6) & _M5, (c >> 5) & 0x1, c & _M5
    r, g, b = _inverse(y, co, cg)
    return _pack_rgb(r, g, g_low, b)


def decorrelate_var2(c):
    r, g, g_low, b = _rgb_fields(c)
    y, co, cg = _forward(r, g, b)
    return (g_low << 15) | (y << 10) | (co << 5) | cg


def recorrelate_var2(c):
    g_low = (c >> 15) & 0x1
    y, co, cg = (c >> 10) & _M5, (c >> 5) & _M5, c & _M5
    r, g, b = _inverse(y, co, cg)
    return _pack_rgb(r, g, g_low, b)


def decorrelate_var3(c):
    r, g, g_low, b = _rgb_fields(c)
    y, co, cg = _forward(r, g, b)
    return (y << 11) | (co << 6) | (cg << 1) | g_low


def recorrelate_var3(c):
    y, co = (c >> 11) & _M5, (c >> 6) & _M5
    cg, g_low = (c >> 1) & _M5, c & 0x1
    r, g, b = _inverse(y, co, cg)
    return _pack_rgb(r, g, g_low, b)


_DECORRELATE = {0: lambda c: c, 1: decorrelate_var1, 2: decorrelate_var2,
                3: decorrelate_var3}
_RECORRELATE = {0: lambda c: c, 1: recorrelate_var1, 2: recorrelate_var2,
                3: recorrelate_var3}


def decorrelate(c: torch.Tensor, variant: int) -> torch.Tensor:
    """16-bit colours (int32) -> decorrelated; variant 0 is the identity."""
    return _DECORRELATE[int(variant)](c)


def recorrelate(c: torch.Tensor, variant: int) -> torch.Tensor:
    """Inverse of :func:`decorrelate`."""
    return _RECORRELATE[int(variant)](c)


def split_pair(p: torch.Tensor):
    """int32 colour words ``c0 | c1 << 16`` -> (c0, c1) as int32 in [0, 65536)."""
    return p & 0xFFFF, (p >> 16) & 0xFFFF


def join_pair(c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_pair` (the shift wraps into bit 31)."""
    return c0 | (c1 << 16)


def decorrelate_pair(p: torch.Tensor, variant: int) -> torch.Tensor:
    """Both halves of int32 colour words decorrelated (the kernels' SWAR form)."""
    if int(variant) == 0:
        return p
    c0, c1 = split_pair(p)
    return join_pair(decorrelate(c0, variant), decorrelate(c1, variant))


def recorrelate_pair(p: torch.Tensor, variant: int) -> torch.Tensor:
    """Inverse of :func:`decorrelate_pair`."""
    if int(variant) == 0:
        return p
    c0, c1 = split_pair(p)
    return join_pair(recorrelate(c0, variant), recorrelate(c1, variant))
