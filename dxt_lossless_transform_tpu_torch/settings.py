"""BC1 transform settings and the auto-search candidate sets.

Counterpart of ``dxt_lossless_transform_tpu/settings.py`` (``YCoCgVariant``,
``Bc1TransformSettings`` and the BC1 candidate tuples), kept as this package's own
copy so that the port imports nothing of the JAX package. The candidate orders are
the reference's: the most likely winner comes last.
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
