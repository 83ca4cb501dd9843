"""Block extraction for analysis and debug tooling (counterpart of
``dxt_lossless_transform_tpu/formats/debug.py:19-68``): carve the raw block payload
out of a DDS file."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from .dds import BLOCK_SIZES, DdsFormat, parse_dds
from .embed import TransformFormat


class TransformFormatFilter(enum.Enum):
    """Which texture formats to extract."""

    ALL = "all"
    BC1 = TransformFormat.BC1
    BC2 = TransformFormat.BC2
    BC3 = TransformFormat.BC3
    BC7 = TransformFormat.BC7

    def matches(self, fmt: TransformFormat) -> bool:
        return self is TransformFormatFilter.ALL or self.value == fmt


@dataclass(frozen=True)
class ExtractedBlocks:
    """The raw block payload carved out of a container file."""

    format: TransformFormat
    data: bytes  # the whole mip chain's blocks, length % block_size == 0

    @property
    def block_size(self) -> int:
        return 8 if self.format in (TransformFormat.BC1, TransformFormat.BC4) else 16

    @property
    def num_blocks(self) -> int:
        return len(self.data) // self.block_size


_DDS_TO_TF = {
    DdsFormat.BC1: TransformFormat.BC1, DdsFormat.BC2: TransformFormat.BC2,
    DdsFormat.BC3: TransformFormat.BC3, DdsFormat.BC7: TransformFormat.BC7,
    DdsFormat.BC4: TransformFormat.BC4, DdsFormat.BC5: TransformFormat.BC5,
}


def extract_blocks_from_dds(
        data: bytes,
        fmt_filter: TransformFormatFilter = TransformFormatFilter.ALL,
) -> Optional[ExtractedBlocks]:
    """The block payload of a DDS file, or None if it is no DDS file of a format
    that ``fmt_filter`` lets through."""
    info = parse_dds(data)
    if info is None:
        return None
    tf = _DDS_TO_TF.get(info.format)
    if tf is None or not fmt_filter.matches(tf):
        return None
    payload = data[info.data_offset:info.data_offset + info.data_length]
    bs = BLOCK_SIZES.get(info.format, 16)
    return ExtractedBlocks(tf, payload[: len(payload) // bs * bs])
