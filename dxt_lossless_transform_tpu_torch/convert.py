"""Map the JAX package's settings and estimator objects to this package's.

The state that crosses between the two packages is the transformed file with its
4-byte header, and the parameters that define the auto-search's choices: settings,
candidate lists and the LTU estimator's offsets. :func:`from_reference` reads those
objects by their attributes, so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from .estimate.ltu import LtuEstimation
from .settings import Bc1TransformSettings, YCoCgVariant


def from_reference(obj):
    """The port's counterpart of a JAX-package ``Bc1TransformSettings``,
    ``YCoCgVariant``, tuple or list of those, or ``LtuEstimation``."""
    if isinstance(obj, (tuple, list)):
        return tuple(from_reference(o) for o in obj)
    if hasattr(obj, "decorrelation_mode") and hasattr(obj, "split_colour_endpoints"):
        return Bc1TransformSettings(YCoCgVariant(int(obj.decorrelation_mode)),
                                    bool(obj.split_colour_endpoints))
    if type(obj).__name__ == "YCoCgVariant":
        return YCoCgVariant(int(obj))
    if type(obj).__name__ == "LtuEstimation" and hasattr(obj, "offsets"):
        return LtuEstimation(tuple(int(k) for k in obj.offsets))
    raise TypeError(f"no counterpart in the port for {type(obj).__name__}")
