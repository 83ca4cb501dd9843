"""BC6H mode-sort transform, untransform and auto-search: the machinery of
:mod:`.bc7` with BC6H's map from byte 0 to the mode id (counterpart of
``dxt_lossless_transform_tpu/ops/bc6h.py``). The untransform reads the ids from the
mode stream, so it is BC7's."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..errors import Bc6hValidationError
from ..estimate.base import SizeEstimation
from ..settings import BC6H_FAST_CANDIDATES, Bc6hTransformSettings
from . import bc7
from .bc7 import BC6H

BLOCK_SIZE = bc7.BLOCK_SIZE


def transform_tensor(x: torch.Tensor, settings: Bc6hTransformSettings) -> torch.Tensor:
    """BC6H blocks (uint8[16n], on any device) -> the transformed bytes."""
    return bc7.transform_tensor(x, settings, BC6H)


def transform(data, settings: Bc6hTransformSettings = Bc6hTransformSettings(),
              device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved BC6H blocks -> the mode-sorted and/or plane-split layout."""
    return bc7.transform_bytes(data, settings, BC6H, Bc6hValidationError, device)


def untransform(data, settings: Bc6hTransformSettings = Bc6hTransformSettings(),
                device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform`."""
    return bc7.untransform_bytes(data, settings, Bc6hValidationError, device)


def transform_bc6h_auto(data, estimator: SizeEstimation,
                        use_all_decorrelation_modes: bool = False,
                        candidates: Optional[Sequence[Bc6hTransformSettings]] = None,
                        device: Union[str, torch.device] = "cuda"):
    """Pick the BC6H layout whose whole transformed stream the estimator ranks
    smallest; returns ``(transformed, settings)``. BC6H has one candidate set, the
    FAST one, whatever ``use_all_decorrelation_modes`` says."""
    cand = candidates if candidates is not None else BC6H_FAST_CANDIDATES
    return bc7.transform_auto(data, estimator, cand, BC6H, "BC6H", Bc6hValidationError,
                              device)
