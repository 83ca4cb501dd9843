"""Map the JAX package's settings, builders and estimator objects to this package's.

The state that crosses between the two packages is the transformed file with its
4-byte header, and the parameters that define the auto-search's choices: settings,
candidate lists, builders and the estimator with its offsets. :func:`from_reference`
reads those objects by their names and attributes, so this module imports nothing
of the JAX package.
"""

from __future__ import annotations

from . import api
from .estimate.base import NoEstimation
from .estimate.ltu import LtuEstimation
from .settings import Bc1TransformSettings, Bc3TransformSettings, YCoCgVariant

_MANUAL = {"Bc1ManualTransformBuilder": api.Bc1ManualTransformBuilder,
           "Bc3ManualTransformBuilder": api.Bc3ManualTransformBuilder}
_AUTO = {"Bc1AutoTransformBuilder": api.Bc1AutoTransformBuilder,
         "Bc3AutoTransformBuilder": api.Bc3AutoTransformBuilder}


def from_reference(obj):
    """The port's counterpart of a JAX-package ``Bc1TransformSettings``,
    ``Bc3TransformSettings``, ``YCoCgVariant``, tuple or list of those, BC1 or BC3
    manual or auto builder, ``LtuEstimation`` or ``NoEstimation``."""
    name = type(obj).__name__
    if isinstance(obj, (tuple, list)):
        return tuple(from_reference(o) for o in obj)
    if name == "Bc3TransformSettings":
        return Bc3TransformSettings(YCoCgVariant(int(obj.decorrelation_mode)),
                                    bool(obj.split_alpha_endpoints),
                                    bool(obj.split_colour_endpoints))
    if name == "Bc1TransformSettings":
        return Bc1TransformSettings(YCoCgVariant(int(obj.decorrelation_mode)),
                                    bool(obj.split_colour_endpoints))
    if name == "YCoCgVariant":
        return YCoCgVariant(int(obj))
    if name == "LtuEstimation" and hasattr(obj, "offsets"):
        return LtuEstimation(tuple(int(k) for k in obj.offsets))
    if name == "NoEstimation":
        return NoEstimation()
    if name in _MANUAL:
        return _MANUAL[name](from_reference(obj.get_settings()))
    if name in _AUTO:
        return _AUTO[name](from_reference(obj._estimator)).use_all_decorrelation_modes(
            obj._use_all)
    raise TypeError(f"no counterpart in the port for {name}")
