"""BC1-BC7, BC6H and RGB transform settings and the auto-search candidate sets.

Counterpart of ``dxt_lossless_transform_tpu/settings.py`` (``YCoCgVariant``, the
``Bc1``-``Bc5TransformSettings`` dataclasses, :33-118, the BC1, BC2 and BC3
candidate tuples, :133-226, the BC7 and BC6H settings and candidates, :118-145,
:226-236 and :268-290, and ``RgbTransformSettings`` with ``RGB_FAST_CANDIDATES``,
:239-265), kept as this package's own copy so that the port imports nothing of the
JAX package. The candidate orders are the reference's: the most likely winner
comes last, and ties go to the first minimum.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, Tuple


class YCoCgVariant(enum.IntEnum):
    """YCoCg-R decorrelation variant; the values are the reference enum's."""

    NONE = 0
    VARIANT1 = 1
    VARIANT2 = 2
    VARIANT3 = 3


@dataclass(frozen=True)
class Bc1TransformSettings:
    """Decorrelation variant, and whether c0 and c1 go to separate streams."""

    decorrelation_mode: YCoCgVariant = YCoCgVariant.VARIANT1
    split_colour_endpoints: bool = True

    @staticmethod
    def all_combinations() -> Iterator["Bc1TransformSettings"]:
        for mode in YCoCgVariant:
            for split in (True, False):
                yield Bc1TransformSettings(mode, split)


@dataclass(frozen=True)
class Bc2TransformSettings:
    """The knobs of BC1: the alpha half of a BC2 block is moved to its own stream
    but never transformed."""

    decorrelation_mode: YCoCgVariant = YCoCgVariant.VARIANT1
    split_colour_endpoints: bool = True

    @staticmethod
    def all_combinations() -> Iterator["Bc2TransformSettings"]:
        for mode in YCoCgVariant:
            for split in (True, False):
                yield Bc2TransformSettings(mode, split)


@dataclass(frozen=True)
class Bc3TransformSettings:
    """Decorrelation variant, and whether the alpha endpoints and the colour
    endpoints each go to two separate streams: 8 stream-layout families."""

    decorrelation_mode: YCoCgVariant = YCoCgVariant.VARIANT1
    split_alpha_endpoints: bool = False
    split_colour_endpoints: bool = False

    @staticmethod
    def all_combinations() -> Iterator["Bc3TransformSettings"]:
        for mode in YCoCgVariant:
            for split_a in (True, False):
                for split_c in (True, False):
                    yield Bc3TransformSettings(mode, split_a, split_c)


@dataclass(frozen=True)
class Bc4TransformSettings:
    """Whether the u8 endpoint pair of a BC4 block goes to two separate streams."""

    split_endpoints: bool = True

    @staticmethod
    def all_combinations() -> Iterator["Bc4TransformSettings"]:
        for split in (True, False):
            yield Bc4TransformSettings(split)


@dataclass(frozen=True)
class Bc5TransformSettings:
    """Whether the u8 endpoint pairs of both BC5 channels go to separate streams."""

    split_endpoints: bool = True

    @staticmethod
    def all_combinations() -> Iterator["Bc5TransformSettings"]:
        for split in (True, False):
            yield Bc5TransformSettings(split)


@dataclass(frozen=True)
class Bc7TransformSettings:
    """Whether the blocks are stable-sorted by mode id within 4096-block chunks
    (with a packed 4-bit mode stream in front), and whether the block bytes are
    written as 16 byte planes. Both off is the identity."""

    sort_by_mode: bool = True
    split_byte_planes: bool = True

    @staticmethod
    def all_combinations() -> Iterator["Bc7TransformSettings"]:
        for sort in (True, False):
            for planes in (True, False):
                yield Bc7TransformSettings(sort, planes)


@dataclass(frozen=True)
class Bc6hTransformSettings:
    """The two knobs of BC7; only the map from byte 0 to the mode id differs."""

    sort_by_mode: bool = True
    split_byte_planes: bool = True

    @staticmethod
    def all_combinations() -> Iterator["Bc6hTransformSettings"]:
        for sort in (True, False):
            for planes in (True, False):
                yield Bc6hTransformSettings(sort, planes)


@dataclass(frozen=True)
class RgbTransformSettings:
    """RGBA8888, BGRA8888 and BGR888: the r' = r - g, b' = b - g (mod 256) lifting,
    and whether the pixels are split into one plane per channel. Both off is the
    identity."""

    decorrelate: bool = True
    split_channels: bool = True

    @staticmethod
    def all_combinations() -> Iterator["RgbTransformSettings"]:
        for dec in (True, False):
            for split in (True, False):
                yield RgbTransformSettings(dec, split)


BC1_FAST_CANDIDATES: Tuple[Bc1TransformSettings, ...] = (
    Bc1TransformSettings(YCoCgVariant.NONE, False),
    Bc1TransformSettings(YCoCgVariant.NONE, True),
    Bc1TransformSettings(YCoCgVariant.VARIANT1, False),
    Bc1TransformSettings(YCoCgVariant.VARIANT1, True),
)

BC1_COMPREHENSIVE_CANDIDATES: Tuple[Bc1TransformSettings, ...] = (
    Bc1TransformSettings(YCoCgVariant.VARIANT2, False),
    Bc1TransformSettings(YCoCgVariant.NONE, False),
    Bc1TransformSettings(YCoCgVariant.NONE, True),
    Bc1TransformSettings(YCoCgVariant.VARIANT3, False),
    Bc1TransformSettings(YCoCgVariant.VARIANT3, True),
    Bc1TransformSettings(YCoCgVariant.VARIANT2, True),
    Bc1TransformSettings(YCoCgVariant.VARIANT1, False),
    Bc1TransformSettings(YCoCgVariant.VARIANT1, True),
)

BC2_FAST_CANDIDATES: Tuple[Bc2TransformSettings, ...] = tuple(
    Bc2TransformSettings(c.decorrelation_mode, c.split_colour_endpoints)
    for c in BC1_FAST_CANDIDATES)

BC2_COMPREHENSIVE_CANDIDATES: Tuple[Bc2TransformSettings, ...] = tuple(
    Bc2TransformSettings(c.decorrelation_mode, c.split_colour_endpoints)
    for c in BC1_COMPREHENSIVE_CANDIDATES)

# (variant, split_alpha_endpoints, split_colour_endpoints)
BC3_FAST_CANDIDATES: Tuple[Bc3TransformSettings, ...] = tuple(
    Bc3TransformSettings(m, sa, sc)
    for (m, sa, sc) in (
        (YCoCgVariant.VARIANT1, True, False),
        (YCoCgVariant.VARIANT1, True, True),
        (YCoCgVariant.NONE, True, False),
        (YCoCgVariant.NONE, False, True),
        (YCoCgVariant.NONE, True, True),
        (YCoCgVariant.VARIANT1, False, True),
        (YCoCgVariant.NONE, False, False),
        (YCoCgVariant.VARIANT1, False, False),
    )
)

BC3_COMPREHENSIVE_CANDIDATES: Tuple[Bc3TransformSettings, ...] = tuple(
    Bc3TransformSettings(m, sa, sc)
    for (m, sa, sc) in (
        (YCoCgVariant.VARIANT2, True, False),
        (YCoCgVariant.VARIANT2, True, True),
        (YCoCgVariant.VARIANT3, True, True),
        (YCoCgVariant.VARIANT3, True, False),
        (YCoCgVariant.VARIANT1, True, False),
        (YCoCgVariant.VARIANT3, False, True),
        (YCoCgVariant.VARIANT1, True, True),
        (YCoCgVariant.VARIANT2, False, True),
        (YCoCgVariant.VARIANT2, False, False),
        (YCoCgVariant.VARIANT3, False, False),
        (YCoCgVariant.NONE, True, False),
        (YCoCgVariant.NONE, False, True),
        (YCoCgVariant.NONE, True, True),
        (YCoCgVariant.VARIANT1, False, True),
        (YCoCgVariant.NONE, False, False),
        (YCoCgVariant.VARIANT1, False, False),
    )
)

# BC7 and BC6H: identity first, the full mode-aware layout last. The reference has
# no BC6H COMPREHENSIVE set: its BC6H search always takes the FAST one.
BC7_FAST_CANDIDATES: Tuple[Bc7TransformSettings, ...] = (
    Bc7TransformSettings(False, False),
    Bc7TransformSettings(True, False),
    Bc7TransformSettings(False, True),
    Bc7TransformSettings(True, True),
)

BC7_COMPREHENSIVE_CANDIDATES: Tuple[Bc7TransformSettings, ...] = BC7_FAST_CANDIDATES

BC6H_FAST_CANDIDATES: Tuple[Bc6hTransformSettings, ...] = tuple(
    Bc6hTransformSettings(c.sort_by_mode, c.split_byte_planes)
    for c in BC7_FAST_CANDIDATES)

# RGB: identity first, the decorrelated channel planes last
RGB_FAST_CANDIDATES: Tuple[RgbTransformSettings, ...] = (
    RgbTransformSettings(False, False),
    RgbTransformSettings(True, False),
    RgbTransformSettings(False, True),
    RgbTransformSettings(True, True),
)
