"""File-format layer: DDS parsing, transform-header embedding, handler dispatch.

Counterpart of ``dxt_lossless_transform_tpu/formats``, with the same names at the
package level: detect the container format, carve out the texture payload, run the
transform over it on the device, and embed a 4-byte header that records how to undo
it, written over the container magic.
"""

from .embed import TransformFormat, TransformHeader  # noqa: F401
from .dds import DdsFormat, DdsInfo, parse_dds, parse_dds_ignore_magic, likely_dds  # noqa: F401
from .errors import (  # noqa: F401
    TransformError,
    FormatHandlerError,
    InvalidDataAlignment,
    NoSupportedHandler,
    NoBuilderForFormat,
    UnknownTransformFormat,
)
from .bundle import TransformBundle  # noqa: F401
from .handlers import DdsHandler, dispatch_transform, dispatch_untransform  # noqa: F401
from .api import (  # noqa: F401
    transform_slice_with_bundle,
    untransform_slice,
    transform_slice_with_multiple_handlers,
    untransform_slice_with_multiple_handlers,
)
from . import file_io  # noqa: F401
