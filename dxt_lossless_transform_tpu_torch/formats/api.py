"""The slice API and the multi-handler dispatch (counterpart of
``dxt_lossless_transform_tpu/formats/api.py:16-44``): one handler over bytes in
memory, or several tried in order through their detection methods. Each handler
runs on the device it was made with (``DdsHandler(device)``)."""

from __future__ import annotations

from typing import Iterable, Optional

from .bundle import TransformBundle
from .errors import NoSupportedHandler
from .handlers import FileFormatHandler


def transform_slice_with_bundle(handler: FileFormatHandler, data: bytes,
                                bundle: TransformBundle) -> bytes:
    return handler.transform_bundle(data, bundle)


def untransform_slice(handler: FileFormatHandler, data: bytes) -> bytes:
    return handler.untransform(data)


def transform_slice_with_multiple_handlers(
        handlers: Iterable[FileFormatHandler], data: bytes, bundle: TransformBundle,
        file_extension: Optional[str] = None) -> bytes:
    """Transform with the first handler whose ``can_handle`` accepts ``data`` (a
    handler without the method accepts everything); raises
    :class:`NoSupportedHandler` when none does."""
    for h in handlers:
        can = getattr(h, "can_handle", None)
        if can is None or can(data, file_extension):
            return h.transform_bundle(data, bundle)
    raise NoSupportedHandler()


def untransform_slice_with_multiple_handlers(
        handlers: Iterable[FileFormatHandler], data: bytes,
        file_extension: Optional[str] = None) -> bytes:
    """Untransform with the first handler whose ``can_handle_untransform`` accepts
    ``data``; raises :class:`NoSupportedHandler` when none does."""
    for h in handlers:
        can = getattr(h, "can_handle_untransform", None)
        if can is None or can(data, file_extension):
            return h.untransform(data)
    raise NoSupportedHandler()
