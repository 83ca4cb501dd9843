"""BC1 builders (counterpart of ``dxt_lossless_transform_tpu/api.py:26-90``).

The auto builder searches for the best settings with a pluggable estimator and hands
back the untransform recipe as a manual builder; the manual builder transforms with
explicit settings. Each call runs on the ``device`` it is given, the CUDA device
unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .estimate.base import NoEstimation, SizeEstimation
from .ops import auto as ops_auto, bc1 as ops_bc1
from .settings import Bc1TransformSettings, YCoCgVariant


class Bc1ManualTransformBuilder:
    def __init__(self, settings: Optional[Bc1TransformSettings] = None):
        self._settings = settings if settings is not None else Bc1TransformSettings()

    def decorrelation_mode(self, variant: YCoCgVariant):
        self._settings = Bc1TransformSettings(YCoCgVariant(variant),
                                              self._settings.split_colour_endpoints)
        return self

    def split_colour_endpoints(self, flag: bool):
        self._settings = Bc1TransformSettings(self._settings.decorrelation_mode,
                                              bool(flag))
        return self

    def get_settings(self) -> Bc1TransformSettings:
        return self._settings

    def transform(self, data: bytes, device: Union[str, torch.device] = "cuda") -> bytes:
        return ops_bc1.transform(data, self._settings, device)

    def untransform(self, data: bytes,
                    device: Union[str, torch.device] = "cuda") -> bytes:
        return ops_bc1.untransform(data, self._settings, device)


class Bc1AutoTransformBuilder:
    def __init__(self, estimator: Optional[SizeEstimation] = None):
        self._estimator = estimator if estimator is not None else NoEstimation()
        self._use_all = False

    @classmethod
    def new_ultra(cls, estimator: SizeEstimation):
        """Search every decorrelation mode (the COMPREHENSIVE candidates)."""
        return cls(estimator).use_all_decorrelation_modes(True)

    def use_all_decorrelation_modes(self, flag: bool):
        self._use_all = bool(flag)
        return self

    def transform(self, data: bytes, device: Union[str, torch.device] = "cuda"):
        """Search, transform, and return ``(transformed, manual_builder)``; the manual
        builder is the untransform recipe."""
        out, settings = ops_auto.transform_bc1_auto(data, self._estimator,
                                                    self._use_all, device=device)
        return out, Bc1ManualTransformBuilder(settings)
