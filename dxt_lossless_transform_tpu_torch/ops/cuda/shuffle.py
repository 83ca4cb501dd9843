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

The rows form (``dlt_bc{1,2,3,4,5}_transform_rows``, in the same sources) ends the
batch pipeline's device-scored step: a batch of B files, file r's n_r blocks at the
start of row r of a (B, block_size·bucket) tensor, each transformed under its own
candidate ``best[r]`` (a device tensor, the step's argmin) into row r of a tensor of
the same shape, in the per-file layout above for n_r blocks; the bytes past
block_size·n_r of a row are not written. One launch a batch (per 65,535 rows), with
no host sync: the candidates are kernel arguments, the block counts go up through a
pinned buffer. :func:`transform_rows` launches the format's;
:func:`transform_rows_plain` runs the per-file plain transform row by row.
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


# ---- the rows form: a batch of files, each under its own winner -------------------------

#: the most candidates a rows kernel takes (4 bits each in one 64-bit argument)
MAX_ROW_CANDIDATES = 16


# per format: block size, the per-file plain transform, and a candidate key's index
# among the kernel's instantiations, as csrc/common.cuh's variant_split_index (BC1,
# BC2), bc3_kernels.cu's bc3_settings_index and with_split (BC4, BC5) define it
_ROWS = {
    "bc1": (8, bc1_transform_plain, lambda v, split: 2 * _check_variant(v) + bool(split)),
    "bc2": (16, bc2_transform_plain, lambda v, split: 2 * _check_variant(v) + bool(split)),
    "bc3": (16, bc3_transform_plain,
            lambda v, split_alpha, split_colour: 4 * _check_variant(v)
            + 2 * bool(split_alpha) + bool(split_colour)),
    "bc4": (8, bc4_transform_plain, lambda split: int(bool(split))),
    "bc5": (16, bc5_transform_plain, lambda split: int(bool(split))),
}


def rows_code(fmt: str, candidates) -> int:
    """The rows kernel's ``code`` argument for ``candidates``: candidate c's index
    among the kernel's instantiations in bits 4c..4c+3, as a signed 64-bit value."""
    code = 0
    for c, key in enumerate(candidates):
        code |= _ROWS[fmt][2](*key) << (4 * c)
    return code - (1 << 64) if code >> 63 else code


def _check_rows(fmt: str, x: torch.Tensor, ns, best: torch.Tensor, candidates) -> tuple:
    """(the (B, block_size·bucket) bytes of ``x``, the block counts as ints)."""
    name = f"{fmt}_transform_rows"
    block_size = _ROWS[fmt][0]
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (B, W) batch, got shape "
                         f"{tuple(x.shape)}")
    rows = x.view(torch.uint8).reshape(x.shape[0], -1)
    if rows.shape[1] % block_size:
        raise ValueError(f"{name}: rows of {rows.shape[1]} bytes are no whole number of "
                         f"{block_size}-byte blocks")
    B, bucket = rows.shape[0], rows.shape[1] // block_size
    ns = [int(n) for n in ns]
    if len(ns) != B or any(n < 0 or n > bucket for n in ns):
        raise ValueError(f"{name}: {len(ns)} block counts for {B} rows of {bucket} "
                         f"blocks, each must lie in [0, {bucket}]")
    if not 0 < len(candidates) <= MAX_ROW_CANDIDATES:
        raise ValueError(f"{name}: takes 1 to {MAX_ROW_CANDIDATES} candidates, got "
                         f"{len(candidates)}")
    if best.shape != (B,) or best.dtype != torch.int64 or best.device != x.device:
        raise ValueError(f"{name}: expected best as ({B},) int64 on {x.device}, got "
                         f"{best.dtype}{tuple(best.shape)} on {best.device}")
    return rows, ns


def transform_rows_plain(fmt: str, x: torch.Tensor, ns, best: torch.Tensor,
                         candidates) -> torch.Tensor:
    """The plain version of :func:`transform_rows`: each row's per-file plain
    transform."""
    rows, ns = _check_rows(fmt, x, ns, best, candidates)
    block_size, plain, _ = _ROWS[fmt]
    out = torch.empty_like(rows)
    for r, (n, k) in enumerate(zip(ns, best.tolist())):
        if n:
            out[r, :block_size * n] = plain(rows[r, :block_size * n], *candidates[k])
    return out


def transform_rows(fmt: str, x: torch.Tensor, ns, best: torch.Tensor,
                   candidates) -> torch.Tensor:
    """A batch's files transformed, each under its own winner: ``x`` (B, W), row r
    holding file r's ``ns[r]`` blocks of format ``fmt`` (``bc1``-``bc5``) at its start
    (the step's int32 words, or bytes); ``best`` (B,) int64 on ``x``'s device, an
    index into ``candidates``, the step's candidate keys ((variant, split) for
    BC1/BC2, (variant, split_alpha, split_colour) for BC3, (split,) for BC4/BC5).
    Returns the (B, block_size·bucket) uint8 rows: row r's first block_size·ns[r]
    bytes are the file's transformed bytes, the rest is not written."""
    candidates = tuple(candidates)
    if not backend.dispatch(x):
        return transform_rows_plain(fmt, x, ns, best, candidates)
    rows, ns = _check_rows(fmt, x, ns, best, candidates)
    block_size = _ROWS[fmt][0]
    name = f"{fmt}_transform_rows"
    backend.require_cuda_tensor(rows, name, torch.uint8, align=block_size)
    out = torch.empty_like(rows)
    B, bucket = rows.shape[0], rows.shape[1] // block_size
    if B and bucket:
        counts = backend.host_buffer(B, torch.int64, x.device)
        counts.numpy()[:] = ns
        counts = backend.to_device(counts, x.device)
        best = best.contiguous()
        backend.launch(f"dlt_{name}", x.device, rows.data_ptr(), out.data_ptr(),
                       counts.data_ptr(), best.data_ptr(), B, bucket,
                       rows_code(fmt, candidates), len(candidates))
    return out
