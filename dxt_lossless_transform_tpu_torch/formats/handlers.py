"""Transform dispatch, the handler protocol and the DDS handler (counterpart of
``dxt_lossless_transform_tpu/formats/handlers.py``, for every format).

Transform: copy the headers, transform the texture payload (every mip and surface in
one call), copy trailing bytes, and write the 4-byte transform header over the DDS
magic. Untransform: read the header, parse the DDS header ignoring the magic,
restore the magic, and invert the payload. Every transform keeps the payload's size
except the BC7/BC6H mode sort, which puts a ceil(n/2)-byte mode stream in front
(:func:`transformed_payload_len`). Detection: :meth:`DdsHandler.can_handle` and
:meth:`DdsHandler.can_handle_untransform`, which the multi-handler functions of
:mod:`.api` ask.
"""

from __future__ import annotations

from typing import Optional, Protocol, Union, runtime_checkable

import torch

from .. import endian
from ..ops import bc1 as ops_bc1, bc2 as ops_bc2, bc3 as ops_bc3, bc45 as ops_bc45
from ..ops import bc6h as ops_bc6h, bc7 as ops_bc7, rgb as ops_rgb
from .bundle import TransformBundle
from .dds import DDS_MAGIC, DdsFormat, likely_dds, parse_dds, parse_dds_ignore_magic
from .embed import TRANSFORM_HEADER_SIZE, TransformFormat, TransformHeader
from .errors import (
    InputTooShort,
    InputTooShortForStatedTextureSize,
    InvalidDataAlignment,
    InvalidInputFileHeader,
    InvalidRestoredFileHeader,
    OutputSizeMismatch,
    UnknownTransformFormat,
    UnsupportedTransformFormat,
)

_ALIGNMENT = {TransformFormat.BC1: 8, TransformFormat.BC2: 16, TransformFormat.BC3: 16,
              TransformFormat.BC4: 8, TransformFormat.BC5: 16, TransformFormat.BC7: 16,
              TransformFormat.BC6H: 16,
              TransformFormat.RGBA8888: 4, TransformFormat.BGRA8888: 4,
              TransformFormat.BGR888: 3}

_DDS_TO_TRANSFORM = {
    DdsFormat.BC1: TransformFormat.BC1,
    DdsFormat.BC2: TransformFormat.BC2,
    DdsFormat.BC3: TransformFormat.BC3,
    DdsFormat.BC7: TransformFormat.BC7,
    DdsFormat.BC6H: TransformFormat.BC6H,
    DdsFormat.BC4: TransformFormat.BC4,
    DdsFormat.BC5: TransformFormat.BC5,
    DdsFormat.RGBA8888: TransformFormat.RGBA8888,
    DdsFormat.BGRA8888: TransformFormat.BGRA8888,
    DdsFormat.BGR888: TransformFormat.BGR888,
}


def dispatch_transform(fmt: TransformFormat, payload: bytes, bundle: TransformBundle,
                       device: Union[str, torch.device] = "cuda"):
    """Check alignment and run the bundle's builder on ``device``; returns
    (payload', header)."""
    div = _ALIGNMENT.get(fmt)
    if div is not None and len(payload) % div:
        raise InvalidDataAlignment(len(payload), div)
    return bundle.dispatch_transform(fmt, payload, device)


def _rgb_untransform(layout: str):
    """The untransform of one pixel layout, as (data, settings, device) -> bytes."""
    def untransform(data, settings, device):
        return ops_rgb.untransform(data, layout, settings, device)
    return untransform


# format -> (untransform, the header's settings accessor)
_UNTRANSFORM = {
    TransformFormat.BC1: (ops_bc1.untransform, TransformHeader.bc1_settings),
    TransformFormat.BC2: (ops_bc2.untransform, TransformHeader.bc2_settings),
    TransformFormat.BC3: (ops_bc3.untransform, TransformHeader.bc3_settings),
    TransformFormat.BC4: (ops_bc45.untransform_bc4, TransformHeader.bc4_settings),
    TransformFormat.BC5: (ops_bc45.untransform_bc5, TransformHeader.bc5_settings),
    TransformFormat.BC7: (ops_bc7.untransform, TransformHeader.bc7_settings),
    TransformFormat.BC6H: (ops_bc6h.untransform, TransformHeader.bc6h_settings),
    **{fmt: (_rgb_untransform(fmt.name.lower()), TransformHeader.rgb_settings)
       for fmt in (TransformFormat.RGBA8888, TransformFormat.BGRA8888,
                   TransformFormat.BGR888)},
}
_MODE_SORT = (TransformFormat.BC7, TransformFormat.BC6H)


def transformed_payload_len(header: TransformHeader, original_len: int) -> int:
    """The transformed payload's size for an ``original_len``-byte texture."""
    if header.format == TransformFormat.BC7:
        return ops_bc7.transformed_len(original_len, header.bc7_settings())
    if header.format == TransformFormat.BC6H:
        return ops_bc7.transformed_len(original_len, header.bc6h_settings())
    return original_len


def dispatch_untransform(header: TransformHeader, payload: bytes,
                         device: Union[str, torch.device] = "cuda") -> bytes:
    """Decode the settings from the header and run the untransform."""
    if header.format not in _UNTRANSFORM:
        raise UnsupportedTransformFormat(header.format)
    untransform, settings_of = _UNTRANSFORM[header.format]
    if header.format in _MODE_SORT:
        settings = settings_of(header)
        try:
            ops_bc7.original_len(len(payload), settings)
        except ValueError:
            raise InvalidDataAlignment(len(payload), _ALIGNMENT[header.format]) from None
        return untransform(payload, settings, device)
    if len(payload) % _ALIGNMENT[header.format]:
        raise InvalidDataAlignment(len(payload), _ALIGNMENT[header.format])
    return untransform(payload, settings_of(header), device)


@runtime_checkable
class FileFormatHandler(Protocol):
    """A container format's handler: it carves out the payload, transforms or
    untransforms it, and writes or reads the 4-byte header."""

    def transform_bundle(self, data: bytes, bundle: TransformBundle) -> bytes: ...
    def untransform(self, data: bytes) -> bytes: ...


class FileFormatDetection(Protocol):
    """A handler that can tell whether it can transform ``data``."""

    def can_handle(self, data: bytes, file_extension: Optional[str] = None) -> bool: ...


class FileFormatUntransformDetection(Protocol):
    """A handler that can tell whether ``data`` is a file it transformed."""

    def can_handle_untransform(self, data: bytes,
                               file_extension: Optional[str] = None) -> bool: ...


class DdsHandler:
    """DDS container handler. ``device`` is where both directions run: the
    bundle's builders transform there and :meth:`untransform` inverts there."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = device

    def transform_bundle(self, data: bytes, bundle: TransformBundle) -> bytes:
        info = parse_dds(data)
        if info is None:
            raise InvalidInputFileHeader("not a parseable DDS file")
        fmt = _DDS_TO_TRANSFORM.get(info.format)
        if fmt is None:
            raise InvalidInputFileHeader(f"unsupported DDS format {info.format}")
        start, end = info.data_offset, info.data_offset + info.data_length
        if len(data) < end:
            raise InputTooShortForStatedTextureSize(end, len(data))
        payload, header = dispatch_transform(fmt, data[start:end], bundle, self.device)
        out = header.to_bytes() + data[TRANSFORM_HEADER_SIZE:start] + payload + data[end:]
        expected = len(data) + transformed_payload_len(header, end - start) - (end - start)
        if len(out) != expected:
            raise OutputSizeMismatch(expected, len(out))
        return out

    def untransform(self, data: bytes) -> bytes:
        if len(data) < TRANSFORM_HEADER_SIZE:
            raise InputTooShort(TRANSFORM_HEADER_SIZE, len(data))
        header = TransformHeader.from_bytes(data)
        info = parse_dds_ignore_magic(data)
        if info is None:
            raise InvalidRestoredFileHeader("not a parseable (transformed) DDS file")
        start = info.data_offset
        end = start + transformed_payload_len(header, info.data_length)
        if len(data) < end:
            raise InputTooShortForStatedTextureSize(end, len(data))
        payload = dispatch_untransform(header, data[start:end], self.device)
        return endian.pack_u32(DDS_MAGIC) + data[4:start] + payload + data[end:]

    # detection (JAX handlers.py:164-177)

    def can_handle(self, data: bytes, file_extension: Optional[str] = None) -> bool:
        return likely_dds(data)

    def can_handle_untransform(self, data: bytes,
                               file_extension: Optional[str] = None) -> bool:
        if len(data) < TRANSFORM_HEADER_SIZE:
            return False
        try:
            TransformHeader.from_bytes(data)
        except UnknownTransformFormat:
            return False
        return parse_dds_ignore_magic(data) is not None
