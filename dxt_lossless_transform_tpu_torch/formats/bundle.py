"""TransformBundle with its BC1-BC5 slots (counterpart of
``dxt_lossless_transform_tpu/formats/bundle.py:35-71``). The other formats' slots
come with their slices of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..api import (
    Bc1AutoTransformBuilder, Bc1ManualTransformBuilder, Bc2AutoTransformBuilder,
    Bc2ManualTransformBuilder, Bc3AutoTransformBuilder, Bc3ManualTransformBuilder,
    Bc4AutoTransformBuilder, Bc4ManualTransformBuilder, Bc5AutoTransformBuilder,
    Bc5ManualTransformBuilder,
)
from .embed import TransformFormat, TransformHeader
from .errors import NoBuilderForFormat

Bc1Builder = Union[Bc1AutoTransformBuilder, Bc1ManualTransformBuilder]
Bc2Builder = Union[Bc2AutoTransformBuilder, Bc2ManualTransformBuilder]
Bc3Builder = Union[Bc3AutoTransformBuilder, Bc3ManualTransformBuilder]
Bc4Builder = Union[Bc4AutoTransformBuilder, Bc4ManualTransformBuilder]
Bc5Builder = Union[Bc5AutoTransformBuilder, Bc5ManualTransformBuilder]

LATER_SLICE = ("; this PyTorch port handles BC1-BC5 so far, and BC6H, BC7 and the "
               "RGB formats come in later slices")

# format -> (bundle slot, header constructor)
_SLOTS = {
    TransformFormat.BC1: ("bc1", TransformHeader.for_bc1),
    TransformFormat.BC2: ("bc2", TransformHeader.for_bc2),
    TransformFormat.BC3: ("bc3", TransformHeader.for_bc3),
    TransformFormat.BC4: ("bc4", TransformHeader.for_bc4),
    TransformFormat.BC5: ("bc5", TransformHeader.for_bc5),
}


class TransformBundle:
    """The builder for each format; a format without one raises
    :class:`NoBuilderForFormat` on dispatch."""

    def __init__(self, bc1: Optional[Bc1Builder] = None,
                 bc2: Optional[Bc2Builder] = None,
                 bc3: Optional[Bc3Builder] = None,
                 bc4: Optional[Bc4Builder] = None,
                 bc5: Optional[Bc5Builder] = None):
        self.bc1 = bc1
        self.bc2 = bc2
        self.bc3 = bc3
        self.bc4 = bc4
        self.bc5 = bc5

    def dispatch_transform(self, fmt: TransformFormat, payload: bytes,
                           device: Union[str, torch.device] = "cuda"):
        """Transform ``payload`` on ``device``; returns
        ``(transformed, TransformHeader)``."""
        if fmt not in _SLOTS:
            raise NoBuilderForFormat(fmt, LATER_SLICE)
        slot, header = _SLOTS[fmt]
        builder = getattr(self, slot)
        if builder is None:
            raise NoBuilderForFormat(fmt)
        if hasattr(builder, "get_settings"):  # manual builder
            out, settings = builder.transform(payload, device), builder.get_settings()
        else:
            out, manual = builder.transform(payload, device)
            settings = manual.get_settings()
        return out, header(settings)
