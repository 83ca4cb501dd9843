"""DDS container parsing (this package's copy of
``dxt_lossless_transform_tpu/formats/dds.py``, which is plain Python).

Behavioral reference: ``dxt-lossless-transform-dds/src/dds/parse_dds.rs`` and
``constants.rs``. Detects the texture format from the legacy FourCC / pixel-format
masks or the DX10 DXGI field, computes the payload offset (0x80, or 0x94 with a DX10
header) and the payload length by walking the whole mipmap chain with 4x4-block
rounding per level.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from .. import endian

DDS_MAGIC = 0x20534444  # 'DDS ' little-endian
DDS_HEADER_SIZE = 0x80
DX10_HEADER_SIZE = 20

_FOURCC_OFFSET = 0x54
_DX10_FORMAT_OFFSET = 0x80
_FLAGS_OFFSET = 0x08
_HEIGHT_OFFSET = 0x0C
_WIDTH_OFFSET = 0x10
_MIPMAP_COUNT_OFFSET = 0x1C
_PF_FLAGS_OFFSET = 0x50
_PF_RGBBITCOUNT_OFFSET = 0x58
_PF_RMASK_OFFSET = 0x5C
_PF_GMASK_OFFSET = 0x60
_PF_BMASK_OFFSET = 0x64
_PF_AMASK_OFFSET = 0x68

_DDSD_MIPMAPCOUNT = 0x20000
_CAPS2_OFFSET = 0x70
_DDSCAPS2_CUBEMAP = 0x200
_DDSCAPS2_CUBEMAP_FACES = 0xFC00  # six POSITIVEX..NEGATIVEZ bits
_DX10_MISCFLAG_OFFSET = 0x88
_DX10_ARRAYSIZE_OFFSET = 0x8C
_DX10_MISC_TEXTURECUBE = 0x4
_DDPF_ALPHAPIXELS = 0x1
_DDPF_ALPHA = 0x2
_DDPF_FOURCC = 0x4
_DDPF_RGB = 0x40
_DDPF_YUV = 0x200
_DDPF_LUMINANCE = 0x20000


def _fourcc(s: bytes) -> int:
    return endian.unpack_u32(s)


_FOURCC_DX10 = _fourcc(b"DX10")
_FOURCC_MAP = {
    _fourcc(b"DXT1"): "BC1",
    _fourcc(b"DXT2"): "BC2",
    _fourcc(b"DXT3"): "BC2",
    _fourcc(b"DXT4"): "BC3",
    _fourcc(b"DXT5"): "BC3",
    _fourcc(b"BC4U"): "BC4",
    _fourcc(b"BC4S"): "BC4",
    _fourcc(b"ATI1"): "BC4",
    _fourcc(b"BC5U"): "BC5",
    _fourcc(b"BC5S"): "BC5",
    _fourcc(b"ATI2"): "BC5",
}

# DXGI format id -> DdsFormat name (constants.rs:30-70)
_DXGI_MAP = {}
for _ids, _name in [
    ((70, 71, 72), "BC1"), ((73, 74, 75), "BC2"), ((76, 77, 78), "BC3"),
    ((79, 80, 81), "BC4"), ((82, 83, 84), "BC5"), ((94, 95, 96), "BC6H"),
    ((97, 98, 99), "BC7"), ((27, 28, 29, 30, 31, 32), "RGBA8888"),
    ((87, 90, 91), "BGRA8888"),
]:
    for _i in _ids:
        _DXGI_MAP[_i] = _name


class DdsFormat(enum.IntEnum):
    """Known data formats within a DDS file (``parse_dds.rs:8-32``)."""

    NOT_A_DDS = 0
    UNKNOWN = 1
    BC1 = 2
    BC2 = 3
    BC3 = 4
    BC6H = 5
    BC7 = 6
    RGBA8888 = 7
    BGRA8888 = 8
    BGR888 = 9
    BC4 = 10
    BC5 = 11


BLOCK_SIZES = {
    DdsFormat.BC1: 8, DdsFormat.BC2: 16, DdsFormat.BC3: 16, DdsFormat.BC4: 8,
    DdsFormat.BC5: 16, DdsFormat.BC6H: 16, DdsFormat.BC7: 16,
}


@dataclass(frozen=True)
class DdsInfo:
    format: DdsFormat
    data_offset: int
    data_length: int


def likely_dds(data: bytes) -> bool:
    """Magic + minimum-length check (``likely_dds.rs:9-13``)."""
    return len(data) >= DDS_HEADER_SIZE and _u32(data, 0) == DDS_MAGIC


def _u32(data, off) -> int:
    # every DDS header field is a little-endian u32 (``parse_dds.rs``), read through
    # the endian layer
    return endian.unpack_u32(data[off:off + 4])


def parse_dds(data: bytes) -> Optional[DdsInfo]:
    """Parse format/offset/length from a DDS file; None if not a known DDS."""
    if not likely_dds(data):
        return None
    return parse_dds_ignore_magic(data)


def parse_dds_ignore_magic(data: bytes) -> Optional[DdsInfo]:
    """Like :func:`parse_dds` but skips magic validation -- used for transformed files
    whose magic holds the transform header (``parse_dds.rs:66-92``)."""
    if len(data) < DDS_HEADER_SIZE:
        return None

    fourcc = _u32(data, _FOURCC_OFFSET)
    if fourcc == _FOURCC_DX10:
        if len(data) < DDS_HEADER_SIZE + DX10_HEADER_SIZE:
            return None
        dxgi = _u32(data, _DX10_FORMAT_OFFSET)
        fmt = DdsFormat[_DXGI_MAP[dxgi]] if dxgi in _DXGI_MAP else DdsFormat.UNKNOWN
        data_offset = DDS_HEADER_SIZE + DX10_HEADER_SIZE
    else:
        pixel_flags = _u32(data, _PF_FLAGS_OFFSET)
        if pixel_flags & _DDPF_FOURCC:
            fmt = (DdsFormat[_FOURCC_MAP[fourcc]] if fourcc in _FOURCC_MAP
                   else DdsFormat.UNKNOWN)
        elif pixel_flags & _DDPF_RGB:
            fmt = _detect_uncompressed_format(data)
        else:
            fmt = DdsFormat.UNKNOWN
        data_offset = DDS_HEADER_SIZE

    length = _calculate_data_length(fmt, data)
    return DdsInfo(fmt, data_offset, 0 if length is None else length)


def _detect_uncompressed_format(data: bytes) -> DdsFormat:
    """RGB-mask-based detection of RGBA8888/BGRA8888/BGR888 (``parse_dds.rs:171-232``)."""
    pixel_flags = _u32(data, _PF_FLAGS_OFFSET)
    bit_count = _u32(data, _PF_RGBBITCOUNT_OFFSET)
    r = _u32(data, _PF_RMASK_OFFSET)
    g = _u32(data, _PF_GMASK_OFFSET)
    b = _u32(data, _PF_BMASK_OFFSET)
    a = _u32(data, _PF_AMASK_OFFSET)
    if bit_count == 24:
        if (r, g, b, a) == (0x00FF0000, 0x0000FF00, 0x000000FF, 0):
            return DdsFormat.BGR888
    elif bit_count == 32 and (pixel_flags & _DDPF_ALPHAPIXELS):
        if (r, g, b, a) == (0x000000FF, 0x0000FF00, 0x00FF0000, 0xFF000000):
            return DdsFormat.RGBA8888
        if (r, g, b, a) == (0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000):
            return DdsFormat.BGRA8888
    return DdsFormat.UNKNOWN


def _mip_chain_length(width, height, mipmaps, per_level) -> int:
    total, w, h = 0, width, height
    for _ in range(mipmaps):
        total = min(total + per_level(w, h), 0xFFFFFFFF)  # saturating, as reference
        w, h = max(w // 2, 1), max(h // 2, 1)
    return total


def _surface_count(data: bytes) -> int:
    """Number of full mip chains in the payload: cubemap faces x array size.

    Beyond the reference, which computes a single chain (``parse_dds.rs:236-331``)
    and leaves the remaining faces as verbatim-copied trailing bytes: counting them
    transforms the whole payload. Legacy caps2 face bits (partial cubemaps allowed
    pre-DX10), or DX10 arraySize x 6 for TEXTURECUBE. Volume (depth) textures keep
    the reference's single-chain behavior."""
    fourcc = _u32(data, _FOURCC_OFFSET)
    if fourcc == _FOURCC_DX10 and len(data) >= DDS_HEADER_SIZE + DX10_HEADER_SIZE:
        arr = max(_u32(data, _DX10_ARRAYSIZE_OFFSET), 1)
        if _u32(data, _DX10_MISCFLAG_OFFSET) & _DX10_MISC_TEXTURECUBE:
            return arr * 6
        return arr
    caps2 = _u32(data, _CAPS2_OFFSET)
    if caps2 & _DDSCAPS2_CUBEMAP:
        faces = bin(caps2 & _DDSCAPS2_CUBEMAP_FACES).count("1")
        return faces or 6
    return 1


def _calculate_data_length(fmt: DdsFormat, data: bytes) -> Optional[int]:
    """Whole-payload length: per-surface mip chain (``parse_dds.rs:236-331``) times
    the cubemap-face/array surface count (framework extension)."""
    flags = _u32(data, _FLAGS_OFFSET)
    height = _u32(data, _HEIGHT_OFFSET)
    width = _u32(data, _WIDTH_OFFSET)
    raw_mips = _u32(data, _MIPMAP_COUNT_OFFSET)
    mipmaps = max(raw_mips, 1) if (flags & _DDSD_MIPMAPCOUNT) else 1

    if fmt in BLOCK_SIZES:
        bs = BLOCK_SIZES[fmt]
        length = _mip_chain_length(
            width, height, mipmaps,
            lambda w, h: ((w + 3) // 4) * ((h + 3) // 4) * bs)
    elif fmt in (DdsFormat.RGBA8888, DdsFormat.BGRA8888):
        length = _mip_chain_length(width, height, mipmaps, lambda w, h: w * h * 4)
    elif fmt == DdsFormat.BGR888:
        length = _mip_chain_length(width, height, mipmaps, lambda w, h: w * h * 3)
    elif fmt == DdsFormat.UNKNOWN:
        length = _uncompressed_unknown_length(data, width, height, mipmaps)
    else:
        return None
    if length is None:
        return None
    return min(length * _surface_count(data), 0xFFFFFFFF)


def _uncompressed_unknown_length(data, width, height, mipmaps) -> Optional[int]:
    pixel_flags = _u32(data, _PF_FLAGS_OFFSET)
    bit_count = _u32(data, _PF_RGBBITCOUNT_OFFSET)
    if not (pixel_flags & (_DDPF_RGB | _DDPF_LUMINANCE | _DDPF_YUV | _DDPF_ALPHA)):
        return 0
    if bit_count % 8:
        return 0
    bpp = bit_count // 8
    if bpp == 0:
        return 0
    return _mip_chain_length(width, height, mipmaps, lambda w, h: w * h * bpp)
