"""TransformBundle with a slot for each format (counterpart of
``dxt_lossless_transform_tpu/formats/bundle.py:31-98``), and ``default_all``, the
manual default of every format."""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import torch

from ..api import (
    Bc1AutoTransformBuilder, Bc1ManualTransformBuilder, Bc2AutoTransformBuilder,
    Bc2ManualTransformBuilder, Bc3AutoTransformBuilder, Bc3ManualTransformBuilder,
    Bc4AutoTransformBuilder, Bc4ManualTransformBuilder, Bc5AutoTransformBuilder,
    Bc5ManualTransformBuilder, Bc6hAutoTransformBuilder, Bc6hManualTransformBuilder,
    Bc7AutoTransformBuilder, Bc7ManualTransformBuilder, RgbAutoTransformBuilder,
    RgbManualTransformBuilder,
)
from .embed import TransformFormat, TransformHeader
from .errors import NoBuilderForFormat, UnsupportedTransformFormat

Bc1Builder = Union[Bc1AutoTransformBuilder, Bc1ManualTransformBuilder]
Bc2Builder = Union[Bc2AutoTransformBuilder, Bc2ManualTransformBuilder]
Bc3Builder = Union[Bc3AutoTransformBuilder, Bc3ManualTransformBuilder]
Bc4Builder = Union[Bc4AutoTransformBuilder, Bc4ManualTransformBuilder]
Bc5Builder = Union[Bc5AutoTransformBuilder, Bc5ManualTransformBuilder]
Bc7Builder = Union[Bc7AutoTransformBuilder, Bc7ManualTransformBuilder]
Bc6hBuilder = Union[Bc6hAutoTransformBuilder, Bc6hManualTransformBuilder]
RgbBuilder = Union[RgbAutoTransformBuilder, RgbManualTransformBuilder]

# format -> (bundle slot, header constructor of the settings)
_SLOTS = {
    TransformFormat.BC1: ("bc1", TransformHeader.for_bc1),
    TransformFormat.BC2: ("bc2", TransformHeader.for_bc2),
    TransformFormat.BC3: ("bc3", TransformHeader.for_bc3),
    TransformFormat.BC4: ("bc4", TransformHeader.for_bc4),
    TransformFormat.BC5: ("bc5", TransformHeader.for_bc5),
    TransformFormat.BC7: ("bc7", TransformHeader.for_bc7),
    TransformFormat.BC6H: ("bc6h", TransformHeader.for_bc6h),
    **{fmt: (fmt.name.lower(), partial(TransformHeader.for_rgb, fmt))
       for fmt in (TransformFormat.RGBA8888, TransformFormat.BGRA8888,
                   TransformFormat.BGR888)},
}


class TransformBundle:
    """The builder for each format; a format without one raises
    :class:`NoBuilderForFormat` on dispatch."""

    def __init__(self, bc1: Optional[Bc1Builder] = None,
                 bc2: Optional[Bc2Builder] = None,
                 bc3: Optional[Bc3Builder] = None,
                 bc4: Optional[Bc4Builder] = None,
                 bc5: Optional[Bc5Builder] = None,
                 bc7: Optional[Bc7Builder] = None,
                 bc6h: Optional[Bc6hBuilder] = None,
                 rgba8888: Optional[RgbBuilder] = None,
                 bgra8888: Optional[RgbBuilder] = None,
                 bgr888: Optional[RgbBuilder] = None):
        self.bc1 = bc1
        self.bc2 = bc2
        self.bc3 = bc3
        self.bc4 = bc4
        self.bc5 = bc5
        self.bc7 = bc7
        self.bc6h = bc6h
        self.rgba8888 = rgba8888
        self.bgra8888 = bgra8888
        self.bgr888 = bgr888

    @staticmethod
    def default_all() -> "TransformBundle":
        """The manual default settings of every format (JAX ``bundle.py:42-57``)."""
        return TransformBundle(
            bc1=Bc1ManualTransformBuilder(),
            bc2=Bc2ManualTransformBuilder(),
            bc3=Bc3ManualTransformBuilder(),
            bc4=Bc4ManualTransformBuilder(),
            bc5=Bc5ManualTransformBuilder(),
            bc7=Bc7ManualTransformBuilder(),
            bc6h=Bc6hManualTransformBuilder(),
            rgba8888=RgbManualTransformBuilder("rgba8888"),
            bgra8888=RgbManualTransformBuilder("bgra8888"),
            bgr888=RgbManualTransformBuilder("bgr888"),
        )

    def dispatch_transform(self, fmt: TransformFormat, payload: bytes,
                           device: Union[str, torch.device] = "cuda"):
        """Transform ``payload`` on ``device``; returns
        ``(transformed, TransformHeader)``."""
        if fmt not in _SLOTS:
            raise UnsupportedTransformFormat(fmt)
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
