"""BC1-BC5 transform and untransform kernels and their plain versions.

``dlt_bc1_transform`` and ``dlt_bc1_untransform`` (``csrc/bc1_kernels.cu``) replace
``dxt_lossless_transform_tpu/ops/pallas/shuffle.py:157`` ``bc1_transform_tpu`` and
``:185`` ``bc1_untransform_tpu``. Both directions map a uint8 tensor of 8n bytes to
another of 8n bytes, laid out as on disk:

- BC1 blocks: colour word ``c0 | c1 << 16`` then index word, per 8-byte block;
- transformed, interleaved: colour words at ``[0, 4n)``, index words at ``[4n, 8n)``;
- transformed, split: c0 u16 at ``[0, 2n)``, c1 u16 at ``[2n, 4n)``, indices at
  ``[4n, 8n)``.

``dlt_bc3_transform`` and ``dlt_bc3_untransform`` (``csrc/bc3_kernels.cu``) replace
``:301`` ``bc3_transform_tpu`` and ``:354`` ``bc3_untransform_tpu``, 16n bytes to
16n bytes:

- BC3 blocks: a0, a1, 6 alpha-index bytes, colour word, colour-index word;
- transformed: alpha endpoints at ``[0, 2n)`` (``a0 | a1 << 8`` u16, or all a0 then
  all a1 when split), the 6 alpha-index bytes of each block at ``[2n, 8n)``, colours
  at ``[8n, 12n)`` (u32, or c0 u16 then c1 u16 when split) and colour indices at
  ``[12n, 16n)``.

``dlt_bc2_transform`` and ``dlt_bc2_untransform`` (``csrc/bc2_kernels.cu``) replace
``:218`` ``bc2_transform_tpu`` and ``:245`` ``bc2_untransform_tpu``, 16n bytes to 16n
bytes:

- BC2 blocks: 8 alpha bytes, colour word, colour-index word;
- transformed: the alpha bytes at ``[0, 8n)``, colours at ``[8n, 12n)`` (u32, or c0
  u16 then c1 u16 when split) and colour indices at ``[12n, 16n)``.

``dlt_bc4_transform``/``dlt_bc4_untransform`` and ``dlt_bc5_transform``/
``dlt_bc5_untransform`` (``csrc/bc45_kernels.cu``) replace ``:420``
``bc4_transform_tpu``, ``:443`` ``bc4_untransform_tpu``, ``:471``
``bc5_transform_tpu`` and ``:501`` ``bc5_untransform_tpu``. A BC4 block (8 bytes) is
one alpha section as in BC3 (a0, a1, 6 index bytes), a BC5 block (16 bytes) two,
red then green:

- BC4 transformed: endpoints at ``[0, 2n)`` (``a0 | a1 << 8`` u16, or all a0 then
  all a1 when split), the 6 index bytes of each block at ``[2n, 8n)``;
- BC5 transformed: red endpoints at ``[0, 2n)``, green endpoints at ``[2n, 4n)``
  (each as BC4's), red index bytes at ``[4n, 10n)``, green at ``[10n, 16n)``.

Any n works, odd or 1; nothing is padded.
"""

from __future__ import annotations

import torch

from ... import backend
from .. import ycocg


def _check_blocks(x: torch.Tensor, what: str, block_size: int = 8) -> int:
    """The block count n of a 1-D uint8 tensor of ``block_size`` * n bytes."""
    if x.dtype != torch.uint8 or x.dim() != 1 or x.numel() % block_size:
        raise ValueError(f"{what}: expected a 1-D uint8 tensor of {block_size}n "
                         f"bytes, got {x.dtype} of shape {tuple(x.shape)}")
    return x.numel() // block_size


def _check_variant(variant: int) -> int:
    if int(variant) not in (0, 1, 2, 3):
        raise ValueError(f"YCoCg variant must be 0-3, got {variant}")
    return int(variant)


def write_colours(dst: torch.Tensor, d: torch.Tensor, split: bool) -> None:
    """Write int32 colour words ``d`` (n of them) into uint8 ``dst`` (4n bytes) as
    one u32 stream, or as the c0 u16 stream followed by the c1 u16 stream."""
    if split:
        dst.view(torch.int16).view(2, -1).copy_(torch.stack(ycocg.split_pair(d)))
    else:
        dst.view(torch.int32).copy_(d)


def read_colours(src: torch.Tensor, split: bool) -> torch.Tensor:
    """Inverse of :func:`write_colours`: int32 colour words from uint8 ``src``."""
    if split:
        halves = src.view(torch.int16).view(2, -1).to(torch.int32) & 0xFFFF
        return ycocg.join_pair(halves[0], halves[1])
    return src.view(torch.int32)


def bc1_transform_plain(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    n = x.numel() // 8
    words = x.view(torch.int32).view(n, 2)
    out = torch.empty_like(x)
    write_colours(out[:4 * n], ycocg.decorrelate_pair(words[:, 0], variant), split)
    out[4 * n:].view(torch.int32).copy_(words[:, 1])
    return out


def bc1_untransform_plain(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    n = x.numel() // 8
    out = torch.empty_like(x)
    words = out.view(torch.int32).view(n, 2)
    words[:, 0] = ycocg.recorrelate_pair(read_colours(x[:4 * n], split), variant)
    words[:, 1] = x[4 * n:].view(torch.int32)
    return out


def bc1_transform(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    """BC1 blocks (uint8[8n]) -> transformed bytes (uint8[8n])."""
    n = _check_blocks(x, "bc1_transform")
    variant = _check_variant(variant)
    if not backend.dispatch(x):
        return bc1_transform_plain(x, variant, split)
    backend.require_cuda_tensor(x, "bc1_transform", torch.uint8, align=8)
    out = torch.empty_like(x)
    if n:
        backend.launch("dlt_bc1_transform", x.device, x.data_ptr(), out.data_ptr(),
                       n, variant, int(bool(split)))
    return out


def bc1_untransform(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    """Transformed bytes (uint8[8n]) -> BC1 blocks (uint8[8n])."""
    n = _check_blocks(x, "bc1_untransform")
    variant = _check_variant(variant)
    if not backend.dispatch(x):
        return bc1_untransform_plain(x, variant, split)
    backend.require_cuda_tensor(x, "bc1_untransform", torch.uint8, align=8)
    out = torch.empty_like(x)
    if n:
        backend.launch("dlt_bc1_untransform", x.device, x.data_ptr(), out.data_ptr(),
                       n, variant, int(bool(split)))
    return out


def write_endpoints(dst: torch.Tensor, sections: torch.Tensor, split: bool) -> None:
    """Write the endpoints (bytes 0-1) of the (n, 8+) alpha sections into uint8
    ``dst`` (2n bytes) as a0, a1 pairs, or as all a0 followed by all a1."""
    n = sections.shape[0]
    if split:
        dst.view(2, n).copy_(sections[:, :2].T)
    else:
        dst.view(n, 2).copy_(sections[:, :2])


def read_endpoints(src: torch.Tensor, split: bool) -> torch.Tensor:
    """The (n, 2) a0, a1 bytes from an endpoint stream (uint8[2n]) of either layout."""
    n = src.numel() // 2
    return src.view(2, n).T if split else src.view(n, 2)


def bc3_transform_plain(x: torch.Tensor, variant: int, split_alpha: bool,
                        split_colour: bool) -> torch.Tensor:
    n = x.numel() // 16
    blocks = x.view(n, 16)
    out = torch.empty_like(x)
    write_endpoints(out[:2 * n], blocks, split_alpha)
    out[2 * n:8 * n].view(n, 6).copy_(blocks[:, 2:8])
    colours = x.view(torch.int32).view(n, 4)[:, 2]
    write_colours(out[8 * n:12 * n], ycocg.decorrelate_pair(colours, variant),
                  split_colour)
    out[12 * n:].view(n, 4).copy_(blocks[:, 12:])
    return out


def bc3_untransform_plain(x: torch.Tensor, variant: int, split_alpha: bool,
                          split_colour: bool) -> torch.Tensor:
    n = x.numel() // 16
    out = torch.empty_like(x)
    blocks = out.view(n, 16)
    blocks[:, :2] = read_endpoints(x[:2 * n], split_alpha)
    blocks[:, 2:8] = x[2 * n:8 * n].view(n, 6)
    out.view(torch.int32).view(n, 4)[:, 2] = ycocg.recorrelate_pair(
        read_colours(x[8 * n:12 * n], split_colour), variant)
    blocks[:, 12:] = x[12 * n:].view(n, 4)
    return out


def bc3_transform(x: torch.Tensor, variant: int, split_alpha: bool,
                  split_colour: bool) -> torch.Tensor:
    """BC3 blocks (uint8[16n]) -> transformed bytes (uint8[16n])."""
    n = _check_blocks(x, "bc3_transform", 16)
    variant = _check_variant(variant)
    if not backend.dispatch(x):
        return bc3_transform_plain(x, variant, split_alpha, split_colour)
    backend.require_cuda_tensor(x, "bc3_transform", torch.uint8, align=16)
    out = torch.empty_like(x)
    if n:
        backend.launch("dlt_bc3_transform", x.device, x.data_ptr(), out.data_ptr(),
                       n, variant, int(bool(split_alpha)), int(bool(split_colour)))
    return out


def bc3_untransform(x: torch.Tensor, variant: int, split_alpha: bool,
                    split_colour: bool) -> torch.Tensor:
    """Transformed bytes (uint8[16n]) -> BC3 blocks (uint8[16n])."""
    n = _check_blocks(x, "bc3_untransform", 16)
    variant = _check_variant(variant)
    if not backend.dispatch(x):
        return bc3_untransform_plain(x, variant, split_alpha, split_colour)
    backend.require_cuda_tensor(x, "bc3_untransform", torch.uint8, align=4)
    out = torch.empty_like(x)
    if n:
        backend.launch("dlt_bc3_untransform", x.device, x.data_ptr(), out.data_ptr(),
                       n, variant, int(bool(split_alpha)), int(bool(split_colour)))
    return out


def bc2_transform_plain(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    n = x.numel() // 16
    blocks = x.view(n, 16)
    out = torch.empty_like(x)
    out[:8 * n].view(n, 8).copy_(blocks[:, :8])
    colours = x.view(torch.int32).view(n, 4)[:, 2]
    write_colours(out[8 * n:12 * n], ycocg.decorrelate_pair(colours, variant), split)
    out[12 * n:].view(n, 4).copy_(blocks[:, 12:])
    return out


def bc2_untransform_plain(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    n = x.numel() // 16
    out = torch.empty_like(x)
    blocks = out.view(n, 16)
    blocks[:, :8] = x[:8 * n].view(n, 8)
    out.view(torch.int32).view(n, 4)[:, 2] = ycocg.recorrelate_pair(
        read_colours(x[8 * n:12 * n], split), variant)
    blocks[:, 12:] = x[12 * n:].view(n, 4)
    return out


def bc2_transform(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    """BC2 blocks (uint8[16n]) -> transformed bytes (uint8[16n])."""
    n = _check_blocks(x, "bc2_transform", 16)
    variant = _check_variant(variant)
    if not backend.dispatch(x):
        return bc2_transform_plain(x, variant, split)
    backend.require_cuda_tensor(x, "bc2_transform", torch.uint8, align=16)
    out = torch.empty_like(x)
    if n:
        backend.launch("dlt_bc2_transform", x.device, x.data_ptr(), out.data_ptr(),
                       n, variant, int(bool(split)))
    return out


def bc2_untransform(x: torch.Tensor, variant: int, split: bool) -> torch.Tensor:
    """Transformed bytes (uint8[16n]) -> BC2 blocks (uint8[16n])."""
    n = _check_blocks(x, "bc2_untransform", 16)
    variant = _check_variant(variant)
    if not backend.dispatch(x):
        return bc2_untransform_plain(x, variant, split)
    backend.require_cuda_tensor(x, "bc2_untransform", torch.uint8, align=8)
    out = torch.empty_like(x)
    if n:
        backend.launch("dlt_bc2_untransform", x.device, x.data_ptr(), out.data_ptr(),
                       n, variant, int(bool(split)))
    return out


def bc4_transform_plain(x: torch.Tensor, split: bool) -> torch.Tensor:
    n = x.numel() // 8
    sections = x.view(n, 8)
    out = torch.empty_like(x)
    write_endpoints(out[:2 * n], sections, split)
    out[2 * n:].view(n, 6).copy_(sections[:, 2:])
    return out


def bc4_untransform_plain(x: torch.Tensor, split: bool) -> torch.Tensor:
    n = x.numel() // 8
    out = torch.empty_like(x)
    sections = out.view(n, 8)
    sections[:, :2] = read_endpoints(x[:2 * n], split)
    sections[:, 2:] = x[2 * n:].view(n, 6)
    return out


def bc5_transform_plain(x: torch.Tensor, split: bool) -> torch.Tensor:
    n = x.numel() // 16
    red, green = x.view(n, 2, 8).unbind(1)
    out = torch.empty_like(x)
    write_endpoints(out[:2 * n], red, split)
    write_endpoints(out[2 * n:4 * n], green, split)
    out[4 * n:10 * n].view(n, 6).copy_(red[:, 2:])
    out[10 * n:].view(n, 6).copy_(green[:, 2:])
    return out


def bc5_untransform_plain(x: torch.Tensor, split: bool) -> torch.Tensor:
    n = x.numel() // 16
    out = torch.empty_like(x)
    red, green = out.view(n, 2, 8).unbind(1)
    red[:, :2] = read_endpoints(x[:2 * n], split)
    green[:, :2] = read_endpoints(x[2 * n:4 * n], split)
    red[:, 2:] = x[4 * n:10 * n].view(n, 6)
    green[:, 2:] = x[10 * n:].view(n, 6)
    return out


def _launch_bc45(name: str, x: torch.Tensor, block_size: int, align: int,
                 split: bool, plain) -> torch.Tensor:
    n = _check_blocks(x, name, block_size)
    if not backend.dispatch(x):
        return plain(x, split)
    backend.require_cuda_tensor(x, name, torch.uint8, align=align)
    out = torch.empty_like(x)
    if n:
        backend.launch(f"dlt_{name}", x.device, x.data_ptr(), out.data_ptr(), n,
                       int(bool(split)))
    return out


def bc4_transform(x: torch.Tensor, split: bool) -> torch.Tensor:
    """BC4 blocks (uint8[8n]) -> transformed bytes (uint8[8n])."""
    return _launch_bc45("bc4_transform", x, 8, 8, split, bc4_transform_plain)


def bc4_untransform(x: torch.Tensor, split: bool) -> torch.Tensor:
    """Transformed bytes (uint8[8n]) -> BC4 blocks (uint8[8n])."""
    return _launch_bc45("bc4_untransform", x, 8, 2, split, bc4_untransform_plain)


def bc5_transform(x: torch.Tensor, split: bool) -> torch.Tensor:
    """BC5 blocks (uint8[16n]) -> transformed bytes (uint8[16n])."""
    return _launch_bc45("bc5_transform", x, 16, 16, split, bc5_transform_plain)


def bc5_untransform(x: torch.Tensor, split: bool) -> torch.Tensor:
    """Transformed bytes (uint8[16n]) -> BC5 blocks (uint8[16n])."""
    return _launch_bc45("bc5_untransform", x, 16, 2, split, bc5_untransform_plain)
