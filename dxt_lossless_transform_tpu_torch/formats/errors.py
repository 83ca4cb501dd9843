"""Error taxonomy of the file-formats layer (counterpart of
``dxt_lossless_transform_tpu/formats/errors.py``; the same class names, so that a
caller can catch the same errors from either package)."""

from __future__ import annotations


class TransformError(Exception):
    """Base class for all transform/untransform failures."""


class FormatHandlerError(TransformError):
    """Errors raised by file-format handlers."""


class InvalidInputFileHeader(FormatHandlerError):
    pass


class InvalidRestoredFileHeader(FormatHandlerError):
    pass


class OutputBufferTooSmall(FormatHandlerError):
    def __init__(self, required: int, actual: int):
        super().__init__(f"output buffer too small: required {required}, actual {actual}")
        self.required, self.actual = required, actual


class InputTooShort(FormatHandlerError):
    def __init__(self, required: int, actual: int):
        super().__init__(f"input too short: required {required}, actual {actual}")
        self.required, self.actual = required, actual


class InputTooShortForStatedTextureSize(FormatHandlerError):
    def __init__(self, required: int, actual: int):
        super().__init__(
            f"input too short for stated texture size: required {required}, actual {actual}")
        self.required, self.actual = required, actual


class NoBuilderForFormat(FormatHandlerError):
    def __init__(self, fmt):
        super().__init__(f"bundle has no builder for format {fmt}")
        self.format = fmt


class OutputSizeMismatch(FormatHandlerError):
    """The assembled output length breaks the size contract (a bug, not bad input)."""

    def __init__(self, expected: int, actual: int):
        super().__init__(f"assembled output is {actual} bytes, contract says {expected}")
        self.expected, self.actual = expected, actual


class UnknownTransformFormat(TransformError):
    def __init__(self, raw=None):
        super().__init__(f"unknown transform format in header: {raw!r}")
        self.raw = raw


class UnsupportedTransformFormat(TransformError):
    """The format tag is recognised but no transform is implemented for it."""

    def __init__(self, fmt):
        super().__init__(f"transform format {fmt} is reserved but not yet supported")
        self.format = fmt


class InvalidDataAlignment(TransformError):
    def __init__(self, size: int, required_divisor: int):
        super().__init__(
            f"texture data size {size} is not divisible by {required_divisor}")
        self.size, self.required_divisor = size, required_divisor


class NoSupportedHandler(TransformError):
    def __init__(self):
        super().__init__("no handler can process this file")


class CorruptedEmbeddedData(TransformError):
    """Embedded header data fails validation (bad version / variant bits)."""
