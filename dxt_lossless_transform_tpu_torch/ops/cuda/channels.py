"""RGBA8888, BGRA8888 and BGR888 channel kernels and their plain versions.

``dlt_rgb_transform`` and ``dlt_rgb_untransform`` (``csrc/rgb_kernels.cu``) replace
``dxt_lossless_transform_tpu/ops/pallas/channels.py:58`` ``split_channels_tpu``,
``:92`` ``merge_channels_tpu``, ``:158`` ``split_bgr_tpu`` and ``:197``
``merge_bgr_tpu``, and the XLA decorrelate-only route of ``ops/rgb.py:31-80``. Both
directions map a uint8 tensor of S·n bytes (n pixels of S = ``stride`` bytes, red,
green and blue at bytes ``ri``, ``gi``, ``bi``) to another of S·n bytes, laid out as
on disk:

- with ``dec``: r' = r - g and b' = b - g, mod 256; green and alpha as they are;
- with ``split``: plane c (byte c of every pixel) at ``[c·n, (c+1)·n)``;
- without: the pixels interleaved.

Any n works, and the tensors may start at any byte; nothing is padded. The kernels
take the channel maps of :data:`LAYOUTS` (green at byte 1, red and blue at 0 and
2). The plain versions view the bytes as (n, S) pixels, lift on ``uint8`` (which
wraps mod 256) and transpose with ``.t().contiguous()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import backend

# pixel layout -> (stride, ri, gi, bi) (dxt_lossless_transform_tpu/oracle/rgb.py:27-31)
LAYOUTS = {
    "rgba8888": (4, 0, 1, 2),
    "bgra8888": (4, 2, 1, 0),
    "bgr888": (3, 2, 1, 0),
}


def _check(x: torch.Tensor, what: str, stride: int, ri: int, gi: int, bi: int) -> int:
    """The pixel count n of a 1-D uint8 tensor of ``stride`` * n bytes."""
    if (stride, ri, gi, bi) not in LAYOUTS.values():
        raise ValueError(f"{what}: no pixel layout has stride {stride} and "
                         f"(ri, gi, bi) = ({ri}, {gi}, {bi})")
    if x.dtype != torch.uint8 or x.dim() != 1 or x.numel() % stride:
        raise ValueError(f"{what}: expected a 1-D uint8 tensor of {stride}n bytes, "
                         f"got {x.dtype} of shape {tuple(x.shape)}")
    return x.numel() // stride


def _lift(px: torch.Tensor, ri: int, gi: int, bi: int, sign: int) -> torch.Tensor:
    """(n, S) pixels with sign * g added to red and blue, mod 256 (a new tensor)."""
    out = px.clone()
    g = px[:, gi]
    out[:, ri] = px[:, ri] + g if sign > 0 else px[:, ri] - g
    out[:, bi] = px[:, bi] + g if sign > 0 else px[:, bi] - g
    return out


def rgb_transform_plain(x: torch.Tensor, stride: int, ri: int, gi: int, bi: int,
                        dec: bool, split: bool) -> torch.Tensor:
    px = x.view(-1, stride)
    if dec:
        px = _lift(px, ri, gi, bi, -1)
    return (px.t() if split else px).contiguous().view(-1)


def rgb_untransform_plain(x: torch.Tensor, stride: int, ri: int, gi: int, bi: int,
                          dec: bool, split: bool) -> torch.Tensor:
    n = x.numel() // stride
    px = x.view(stride, n).t() if split else x.view(n, stride)
    if dec:
        px = _lift(px, ri, gi, bi, 1)
    return px.contiguous().view(-1)


def _launch(name: str, plain, x: torch.Tensor, stride: int, ri: int, gi: int, bi: int,
            dec: bool, split: bool, out: Optional[torch.Tensor]) -> torch.Tensor:
    n = _check(x, name, stride, ri, gi, bi)
    if out is not None and (out.dtype != torch.uint8 or out.shape != x.shape
                            or out.device != x.device):
        raise ValueError(f"{name}: out must be uint8[{x.numel()}] on {x.device}, got "
                         f"{out.dtype}{tuple(out.shape)} on {out.device}")
    if not backend.dispatch(x):
        result = plain(x, stride, ri, gi, bi, dec, split)
        return result if out is None else out.copy_(result)
    backend.require_cuda_tensor(x, name, torch.uint8, align=1)
    if out is None:
        out = torch.empty_like(x)
    backend.require_cuda_tensor(out, f"{name} out", torch.uint8, align=1)
    if n:
        backend.launch(f"dlt_{name}", x.device, x.data_ptr(), out.data_ptr(), n, stride,
                       ri, gi, bi, int(bool(dec)), int(bool(split)))
    return out


def rgb_transform(x: torch.Tensor, stride: int, ri: int, gi: int, bi: int, dec: bool,
                  split: bool, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixels (uint8[S·n]) -> transformed bytes (uint8[S·n]), written into ``out``
    when it is given (uint8[S·n] on ``x``'s device, not overlapping ``x``). Either
    may start at any byte."""
    return _launch("rgb_transform", rgb_transform_plain, x, stride, ri, gi, bi, dec,
                   split, out)


def rgb_untransform(x: torch.Tensor, stride: int, ri: int, gi: int, bi: int, dec: bool,
                    split: bool, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transformed bytes (uint8[S·n]) -> pixels (uint8[S·n]); ``out`` as in
    :func:`rgb_transform`."""
    return _launch("rgb_untransform", rgb_untransform_plain, x, stride, ri, gi, bi, dec,
                   split, out)
