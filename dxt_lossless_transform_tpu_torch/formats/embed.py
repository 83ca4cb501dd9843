"""The 4-byte transform header, written over the container magic.

Counterpart of ``dxt_lossless_transform_tpu/formats/embed.py`` with BC1-BC5, BC7,
BC6H and RGB packing (:94-110, :139-218). On disk it is one little-endian u32:

    bits 0-3:  transform format tag
    bits 4-31: format-specific data; for BC1, BC2 and BC3:
               bits 0-1 header version (0), bit 2 split colour endpoints,
               bits 3-4 decorrelation variant (0=Variant1, 1=Variant2, 2=Variant3,
               3=None), and for BC3 bit 5 split alpha endpoints;
               for BC4 and BC5: bits 0-1 header version (0), bit 2 split endpoints;
               for BC7 and BC6H: bits 0-1 header version (0), bit 2 sort by
               mode, bit 3 split byte planes;
               for RGBA8888, BGRA8888 and BGR888: bits 0-1 header version (0),
               bit 2 decorrelate, bit 3 split channels
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

from ..settings import (
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
    Bc4TransformSettings, Bc5TransformSettings, Bc6hTransformSettings,
    Bc7TransformSettings, RgbTransformSettings, YCoCgVariant,
)
from .errors import CorruptedEmbeddedData, UnknownTransformFormat

TRANSFORM_HEADER_SIZE = 4


class TransformFormat(enum.IntEnum):
    """u4 format tags (``embed/transform_format.rs:10-31``)."""

    BC1 = 0x00
    BC2 = 0x01
    BC3 = 0x02
    BC7 = 0x03
    BC6H = 0x04
    RGBA8888 = 0x05
    BGRA8888 = 0x06
    BGR888 = 0x07
    BC4 = 0x08
    BC5 = 0x09


# YCoCgVariant <-> its 2-bit header code (not the enum values)
_VARIANT_TO_BITS = {
    YCoCgVariant.VARIANT1: 0,
    YCoCgVariant.VARIANT2: 1,
    YCoCgVariant.VARIANT3: 2,
    YCoCgVariant.NONE: 3,
}
_BITS_TO_VARIANT = {v: k for k, v in _VARIANT_TO_BITS.items()}


def _pack_bc1_like(settings) -> int:
    return ((int(settings.split_colour_endpoints) << 2)
            | (_VARIANT_TO_BITS[YCoCgVariant(settings.decorrelation_mode)] << 3))


def _unpack_bc1_like(data: int) -> tuple:
    """-> (variant, split_colour); raises for a header version other than 0."""
    if data & 0x3:
        raise CorruptedEmbeddedData(f"unsupported header version {data & 0x3}")
    return _BITS_TO_VARIANT[(data >> 3) & 0x3], bool((data >> 2) & 1)


def _check_version(fmt: str, data: int) -> None:
    if data & 0x3:
        raise CorruptedEmbeddedData(f"unsupported {fmt} header version {data & 0x3}")


def _unpack_split_endpoints(fmt: str, data: int) -> bool:
    """BC4/BC5 -> split_endpoints; raises for a header version other than 0."""
    _check_version(fmt, data)
    return bool((data >> 2) & 1)


def _pack_mode_sort(settings) -> int:
    return (int(settings.sort_by_mode) << 2) | (int(settings.split_byte_planes) << 3)


def _unpack_mode_sort(fmt: str, data: int) -> tuple:
    """BC7/BC6H -> (sort_by_mode, split_byte_planes); raises for a header version
    other than 0."""
    _check_version(fmt, data)
    return bool((data >> 2) & 1), bool((data >> 3) & 1)


@dataclass(frozen=True)
class TransformHeader:
    """A parsed 4-byte transform header."""

    format: TransformFormat
    data: int  # 28-bit format-specific field

    def to_bytes(self) -> bytes:
        return struct.pack("<I", (int(self.format) & 0xF)
                           | ((self.data & 0x0FFFFFFF) << 4))

    @staticmethod
    def from_bytes(raw: bytes) -> "TransformHeader":
        if len(raw) < TRANSFORM_HEADER_SIZE:
            raise UnknownTransformFormat(raw)
        word = struct.unpack_from("<I", raw)[0]
        try:
            fmt = TransformFormat(word & 0xF)
        except ValueError:
            raise UnknownTransformFormat(word & 0xF) from None
        return TransformHeader(fmt, word >> 4)

    @staticmethod
    def for_bc1(settings: Bc1TransformSettings) -> "TransformHeader":
        return TransformHeader(TransformFormat.BC1, _pack_bc1_like(settings))

    def bc1_settings(self) -> Bc1TransformSettings:
        return Bc1TransformSettings(*_unpack_bc1_like(self.data))

    @staticmethod
    def for_bc2(settings: Bc2TransformSettings) -> "TransformHeader":
        return TransformHeader(TransformFormat.BC2, _pack_bc1_like(settings))

    def bc2_settings(self) -> Bc2TransformSettings:
        return Bc2TransformSettings(*_unpack_bc1_like(self.data))

    @staticmethod
    def for_bc3(settings: Bc3TransformSettings) -> "TransformHeader":
        data = _pack_bc1_like(settings) | (int(settings.split_alpha_endpoints) << 5)
        return TransformHeader(TransformFormat.BC3, data)

    def bc3_settings(self) -> Bc3TransformSettings:
        variant, split_colour = _unpack_bc1_like(self.data)
        return Bc3TransformSettings(variant, bool((self.data >> 5) & 1), split_colour)

    @staticmethod
    def for_bc4(settings: Bc4TransformSettings) -> "TransformHeader":
        return TransformHeader(TransformFormat.BC4, int(settings.split_endpoints) << 2)

    def bc4_settings(self) -> Bc4TransformSettings:
        return Bc4TransformSettings(_unpack_split_endpoints("BC4", self.data))

    @staticmethod
    def for_bc5(settings: Bc5TransformSettings) -> "TransformHeader":
        return TransformHeader(TransformFormat.BC5, int(settings.split_endpoints) << 2)

    def bc5_settings(self) -> Bc5TransformSettings:
        return Bc5TransformSettings(_unpack_split_endpoints("BC5", self.data))

    @staticmethod
    def for_bc7(settings: Bc7TransformSettings) -> "TransformHeader":
        return TransformHeader(TransformFormat.BC7, _pack_mode_sort(settings))

    def bc7_settings(self) -> Bc7TransformSettings:
        return Bc7TransformSettings(*_unpack_mode_sort("BC7", self.data))

    @staticmethod
    def for_bc6h(settings: Bc6hTransformSettings) -> "TransformHeader":
        return TransformHeader(TransformFormat.BC6H, _pack_mode_sort(settings))

    def bc6h_settings(self) -> Bc6hTransformSettings:
        return Bc6hTransformSettings(*_unpack_mode_sort("BC6H", self.data))

    @staticmethod
    def for_rgb(fmt: TransformFormat, settings: RgbTransformSettings) -> "TransformHeader":
        """``fmt`` is one of the three uncompressed formats; any other raises
        :class:`UnknownTransformFormat`, as in the JAX package."""
        if fmt not in (TransformFormat.RGBA8888, TransformFormat.BGRA8888,
                       TransformFormat.BGR888):
            raise UnknownTransformFormat(fmt)
        data = (int(settings.decorrelate) << 2) | (int(settings.split_channels) << 3)
        return TransformHeader(fmt, data)

    def rgb_settings(self) -> RgbTransformSettings:
        _check_version("RGB", self.data)
        return RgbTransformSettings(bool((self.data >> 2) & 1), bool((self.data >> 3) & 1))
