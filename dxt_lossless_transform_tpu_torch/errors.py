"""Typed errors of the ops layer (counterpart of
``dxt_lossless_transform_tpu/errors.py``, cut down to what BC1-BC7, BC6H and the RGB
formats need), plus the errors for a missing card and a missing zstd library.

Validation errors subclass :class:`ValueError` and auto-transform errors
:class:`RuntimeError`, as in the reference package.
"""

from __future__ import annotations


class DltError(Exception):
    """Base class of every typed error this package raises."""


class ValidationError(DltError, ValueError):
    """Input failed a length/alignment precondition."""

    def __init__(self, fmt: str, length: int, divisor: int = 0, message: str = ""):
        self.fmt = fmt
        self.length = length
        self.divisor = divisor
        if not message:
            message = (f"{fmt} data length {length} not divisible by {divisor}"
                       if divisor else f"{fmt}: invalid input of length {length}")
        super().__init__(message)


class Bc1ValidationError(ValidationError):
    def __init__(self, length: int, divisor: int = 8, message: str = ""):
        super().__init__("BC1", length, divisor, message)


class Bc3ValidationError(ValidationError):
    def __init__(self, length: int, divisor: int = 16, message: str = ""):
        super().__init__("BC3", length, divisor, message)


class Bc2ValidationError(ValidationError):
    def __init__(self, length: int, divisor: int = 16, message: str = ""):
        super().__init__("BC2", length, divisor, message)


class Bc4ValidationError(ValidationError):
    def __init__(self, length: int, divisor: int = 8, message: str = ""):
        super().__init__("BC4", length, divisor, message)


class Bc5ValidationError(ValidationError):
    def __init__(self, length: int, divisor: int = 16, message: str = ""):
        super().__init__("BC5", length, divisor, message)


class Bc7ValidationError(ValidationError):
    def __init__(self, length: int, divisor: int = 16, message: str = ""):
        super().__init__("BC7", length, divisor, message)


class Bc6hValidationError(ValidationError):
    def __init__(self, length: int, divisor: int = 16, message: str = ""):
        super().__init__("BC6H", length, divisor, message)


class RgbValidationError(ValidationError):
    """``layout`` is the pixel layout (``"rgba8888"``, ``"bgra8888"`` or
    ``"bgr888"``) and ``divisor`` its pixel size."""

    def __init__(self, layout: str, length: int, divisor: int, message: str = ""):
        super().__init__(layout, length, divisor, message)


class AutoTransformError(DltError, RuntimeError):
    """The candidate search failed, typically because the estimator raised."""

    def __init__(self, fmt: str, message: str):
        self.fmt = fmt
        super().__init__(f"{fmt} auto-transform failed: {message}")


class DeviceUnavailableError(DltError, RuntimeError):
    """A CUDA device was asked for (the default) but none is available."""


class ZstdUnavailableError(DltError, RuntimeError):
    """The zstd library (``libzstd.so.1``) could not be loaded."""

    def __init__(self, library: str, reason: str):
        self.library = library
        super().__init__(f"cannot load the zstd library {library}: {reason}")
