"""TransformBundle with its BC1 slot (counterpart of
``dxt_lossless_transform_tpu/formats/bundle.py``). The other formats' slots come with
their slices of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..api import Bc1AutoTransformBuilder, Bc1ManualTransformBuilder
from .embed import TransformFormat, TransformHeader
from .errors import NoBuilderForFormat

Bc1Builder = Union[Bc1AutoTransformBuilder, Bc1ManualTransformBuilder]

LATER_SLICE = ("; this PyTorch port handles BC1 only so far, and BC2-BC7 and the RGB "
               "formats come in later slices")


class TransformBundle:
    """The builder for each format; a format without one raises
    :class:`NoBuilderForFormat` on dispatch."""

    def __init__(self, bc1: Optional[Bc1Builder] = None):
        self.bc1 = bc1

    def dispatch_transform(self, fmt: TransformFormat, payload: bytes,
                           device: Union[str, torch.device] = "cuda"):
        """Transform ``payload`` on ``device``; returns
        ``(transformed, TransformHeader)``."""
        if fmt != TransformFormat.BC1:
            raise NoBuilderForFormat(fmt, LATER_SLICE)
        if self.bc1 is None:
            raise NoBuilderForFormat(fmt)
        if isinstance(self.bc1, Bc1ManualTransformBuilder):
            out, settings = self.bc1.transform(payload, device), self.bc1.get_settings()
        else:
            out, manual = self.bc1.transform(payload, device)
            settings = manual.get_settings()
        return out, TransformHeader.for_bc1(settings)
