"""BC1-BC7, BC6H and RGB builders (counterpart of
``dxt_lossless_transform_tpu/api.py:26-333``).

An auto builder searches for the best settings with a pluggable estimator and hands
back the untransform recipe as a manual builder; a manual builder transforms with
explicit settings. Each call runs on the ``device`` it is given, the CUDA device
unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .estimate.base import NoEstimation, SizeEstimation
from .ops import auto as ops_auto, bc1 as ops_bc1, bc2 as ops_bc2, bc3 as ops_bc3
from .ops import bc45 as ops_bc45, bc6h as ops_bc6h, bc7 as ops_bc7, rgb as ops_rgb
from .settings import (
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
    Bc4TransformSettings, Bc5TransformSettings, Bc6hTransformSettings,
    Bc7TransformSettings, RgbTransformSettings, YCoCgVariant,
)


class _ManualBuilder:
    _settings_cls = None  # the format's settings dataclass
    _transform = None     # the format's (data, settings, device) -> bytes
    _untransform = None

    def __init__(self, settings=None):
        self._settings = settings if settings is not None else type(self)._settings_cls()

    def _with(self, **changes):
        self._settings = type(self._settings)(**{**self._settings.__dict__, **changes})
        return self

    def get_settings(self):
        return self._settings

    def transform(self, data: bytes, device: Union[str, torch.device] = "cuda") -> bytes:
        return type(self)._transform(data, self._settings, device)

    def untransform(self, data: bytes,
                    device: Union[str, torch.device] = "cuda") -> bytes:
        return type(self)._untransform(data, self._settings, device)


class _ColourManualBuilder(_ManualBuilder):
    """A manual builder of a format with a colour half (BC1-BC3)."""

    def decorrelation_mode(self, variant: YCoCgVariant):
        return self._with(decorrelation_mode=YCoCgVariant(variant))

    def split_colour_endpoints(self, flag: bool):
        return self._with(split_colour_endpoints=bool(flag))


class _EndpointManualBuilder(_ManualBuilder):
    """A manual builder of BC4 or BC5, whose one knob splits the endpoints."""

    def split_endpoints(self, flag: bool):
        return self._with(split_endpoints=bool(flag))


class _ModeSortManualBuilder(_ManualBuilder):
    """A manual builder of BC7 or BC6H: mode sort and byte planes."""

    def sort_by_mode(self, flag: bool):
        return self._with(sort_by_mode=bool(flag))

    def split_byte_planes(self, flag: bool):
        return self._with(split_byte_planes=bool(flag))


class _AutoBuilder:
    _search = None  # the format's auto-search, (data, estimator, use_all, device=)
    _manual = None  # the format's manual builder class

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
        out, settings = type(self)._search(data, self._estimator, self._use_all,
                                           device=device)
        return out, type(self)._manual(settings)


class Bc1ManualTransformBuilder(_ColourManualBuilder):
    _settings_cls = Bc1TransformSettings
    _transform = staticmethod(ops_bc1.transform)
    _untransform = staticmethod(ops_bc1.untransform)


class Bc1AutoTransformBuilder(_AutoBuilder):
    _search = staticmethod(ops_auto.transform_bc1_auto)
    _manual = Bc1ManualTransformBuilder


class Bc2ManualTransformBuilder(_ColourManualBuilder):
    _settings_cls = Bc2TransformSettings
    _transform = staticmethod(ops_bc2.transform)
    _untransform = staticmethod(ops_bc2.untransform)


class Bc2AutoTransformBuilder(_AutoBuilder):
    _search = staticmethod(ops_auto.transform_bc2_auto)
    _manual = Bc2ManualTransformBuilder


class Bc3ManualTransformBuilder(_ColourManualBuilder):
    _settings_cls = Bc3TransformSettings
    _transform = staticmethod(ops_bc3.transform)
    _untransform = staticmethod(ops_bc3.untransform)

    def split_alpha_endpoints(self, flag: bool):
        return self._with(split_alpha_endpoints=bool(flag))


class Bc3AutoTransformBuilder(_AutoBuilder):
    _search = staticmethod(ops_auto.transform_bc3_auto)
    _manual = Bc3ManualTransformBuilder


class Bc4ManualTransformBuilder(_EndpointManualBuilder):
    _settings_cls = Bc4TransformSettings
    _transform = staticmethod(ops_bc45.transform_bc4)
    _untransform = staticmethod(ops_bc45.untransform_bc4)


class Bc4AutoTransformBuilder(_AutoBuilder):
    _search = staticmethod(ops_bc45.transform_bc4_auto)
    _manual = Bc4ManualTransformBuilder


class Bc5ManualTransformBuilder(_EndpointManualBuilder):
    _settings_cls = Bc5TransformSettings
    _transform = staticmethod(ops_bc45.transform_bc5)
    _untransform = staticmethod(ops_bc45.untransform_bc5)


class Bc5AutoTransformBuilder(_AutoBuilder):
    _search = staticmethod(ops_bc45.transform_bc5_auto)
    _manual = Bc5ManualTransformBuilder


class Bc7ManualTransformBuilder(_ModeSortManualBuilder):
    _settings_cls = Bc7TransformSettings
    _transform = staticmethod(ops_bc7.transform)
    _untransform = staticmethod(ops_bc7.untransform)


class Bc7AutoTransformBuilder(_AutoBuilder):
    _search = staticmethod(ops_bc7.transform_bc7_auto)
    _manual = Bc7ManualTransformBuilder


class Bc6hManualTransformBuilder(_ModeSortManualBuilder):
    _settings_cls = Bc6hTransformSettings
    _transform = staticmethod(ops_bc6h.transform)
    _untransform = staticmethod(ops_bc6h.untransform)


class Bc6hAutoTransformBuilder(_AutoBuilder):
    _search = staticmethod(ops_bc6h.transform_bc6h_auto)
    _manual = Bc6hManualTransformBuilder


def _check_layout(layout: str) -> str:
    if layout not in ops_rgb.LAYOUTS:
        raise ValueError(f"unknown pixel layout {layout!r}")
    return layout


class RgbManualTransformBuilder(_ManualBuilder):
    """Manual builder of the uncompressed formats; ``layout`` is ``"rgba8888"``,
    ``"bgra8888"`` or ``"bgr888"``."""

    _settings_cls = RgbTransformSettings

    def __init__(self, layout: str, settings: Optional[RgbTransformSettings] = None):
        self.layout = _check_layout(layout)
        super().__init__(settings)

    def decorrelate(self, flag: bool):
        return self._with(decorrelate=bool(flag))

    def split_channels(self, flag: bool):
        return self._with(split_channels=bool(flag))

    def transform(self, data: bytes, device: Union[str, torch.device] = "cuda") -> bytes:
        return ops_rgb.transform(data, self.layout, self._settings, device)

    def untransform(self, data: bytes,
                    device: Union[str, torch.device] = "cuda") -> bytes:
        return ops_rgb.untransform(data, self.layout, self._settings, device)


class RgbAutoTransformBuilder(_AutoBuilder):
    """Auto builder of the uncompressed formats: the estimator picks the layout."""

    def __init__(self, layout: str, estimator: Optional[SizeEstimation] = None):
        super().__init__(estimator)
        self.layout = _check_layout(layout)

    @classmethod
    def new_ultra(cls, layout: str, estimator: SizeEstimation):
        return cls(layout, estimator).use_all_decorrelation_modes(True)

    def transform(self, data: bytes, device: Union[str, torch.device] = "cuda"):
        out, settings = ops_rgb.transform_rgb_auto(data, self.layout, self._estimator,
                                                   self._use_all, device=device)
        return out, RgbManualTransformBuilder(self.layout, settings)
