"""Map the JAX package's settings, builders and estimator objects to this package's.

The state that crosses between the two packages is the transformed file with its
4-byte header, and the parameters that define the auto-search's choices: settings,
candidate lists, builders and the estimator with its offsets or level.
:func:`from_reference` reads those objects by their names and attributes, and
:func:`to_reference` builds the JAX package's settings from classes it is handed, so
this module imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum

from . import api
from .estimate.base import NoEstimation
from .estimate.ltu import LtuEstimation
from .estimate.zstd import ZstdEstimation
from .settings import (
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
    Bc4TransformSettings, Bc5TransformSettings, Bc6hTransformSettings,
    Bc7TransformSettings, RgbTransformSettings, YCoCgVariant,
)

_FORMATS = ("Bc1", "Bc2", "Bc3", "Bc4", "Bc5", "Bc7", "Bc6h")
_MANUAL = {f"{f}ManualTransformBuilder": getattr(api, f"{f}ManualTransformBuilder")
           for f in _FORMATS}
_AUTO = {f"{f}AutoTransformBuilder": getattr(api, f"{f}AutoTransformBuilder")
         for f in _FORMATS}
# settings with a decorrelation variant and split colour endpoints
_COLOUR = {"Bc1TransformSettings": Bc1TransformSettings,
           "Bc2TransformSettings": Bc2TransformSettings}
# settings with split endpoints only
_ENDPOINTS = {"Bc4TransformSettings": Bc4TransformSettings,
              "Bc5TransformSettings": Bc5TransformSettings}
# settings with a mode sort and byte planes
_MODE_SORT = {"Bc7TransformSettings": Bc7TransformSettings,
              "Bc6hTransformSettings": Bc6hTransformSettings}


def from_reference(obj):
    """The port's counterpart of a JAX-package ``Bc1``-``Bc7``, ``Bc6h`` or
    ``RgbTransformSettings``, ``YCoCgVariant``, tuple or list of those, manual or
    auto builder of those formats, ``LtuEstimation``, ``ZstdEstimation`` or
    ``NoEstimation``."""
    name = type(obj).__name__
    if isinstance(obj, (tuple, list)):
        return tuple(from_reference(o) for o in obj)
    if name == "Bc3TransformSettings":
        return Bc3TransformSettings(YCoCgVariant(int(obj.decorrelation_mode)),
                                    bool(obj.split_alpha_endpoints),
                                    bool(obj.split_colour_endpoints))
    if name in _COLOUR:
        return _COLOUR[name](YCoCgVariant(int(obj.decorrelation_mode)),
                             bool(obj.split_colour_endpoints))
    if name in _ENDPOINTS:
        return _ENDPOINTS[name](bool(obj.split_endpoints))
    if name in _MODE_SORT:
        return _MODE_SORT[name](bool(obj.sort_by_mode), bool(obj.split_byte_planes))
    if name == "RgbTransformSettings":
        return RgbTransformSettings(bool(obj.decorrelate), bool(obj.split_channels))
    if name == "RgbManualTransformBuilder":
        return api.RgbManualTransformBuilder(obj.layout,
                                             from_reference(obj.get_settings()))
    if name == "RgbAutoTransformBuilder":
        return api.RgbAutoTransformBuilder(
            obj.layout, from_reference(obj._estimator)).use_all_decorrelation_modes(
                obj._use_all)
    if name == "YCoCgVariant":
        return YCoCgVariant(int(obj))
    if name == "LtuEstimation" and hasattr(obj, "offsets"):
        return LtuEstimation(tuple(int(k) for k in obj.offsets))
    if name == "NoEstimation":
        return NoEstimation()
    if name == "ZstdEstimation":
        return ZstdEstimation(int(obj.level))
    if name in _MANUAL:
        return _MANUAL[name](from_reference(obj.get_settings()))
    if name in _AUTO:
        return _AUTO[name](from_reference(obj._estimator)).use_all_decorrelation_modes(
            obj._use_all)
    raise TypeError(f"no counterpart in the port for {name}")


def to_reference(settings, reference_settings):
    """The JAX package's counterpart of one of the port's settings dataclasses.
    ``reference_settings`` is that package's ``settings`` module, passed in, since
    this package imports nothing of it."""
    cls = getattr(reference_settings, type(settings).__name__)
    fields = {}
    for field in dataclasses.fields(settings):
        value = getattr(settings, field.name)
        if isinstance(value, enum.Enum):
            value = getattr(reference_settings, type(value).__name__)(value.value)
        fields[field.name] = value
    return cls(**fields)
