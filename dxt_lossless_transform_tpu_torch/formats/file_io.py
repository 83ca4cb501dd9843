"""File in, file out (counterpart of
``dxt_lossless_transform_tpu/formats/file_io.py:22-67``): the input file is mapped
read-only and copied out once, the output is written in one call. Each function
returns the number of bytes written."""

from __future__ import annotations

import mmap
import os
from typing import Iterable, Optional

from .api import (
    transform_slice_with_multiple_handlers, untransform_slice_with_multiple_handlers,
)
from .bundle import TransformBundle
from .handlers import FileFormatHandler


def _read_mmap(path) -> bytes:
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return b""
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
            return bytes(m)


def _write(path, data: bytes) -> int:
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def transform_file_with_handler(handler: FileFormatHandler, bundle: TransformBundle,
                                input_path, output_path) -> int:
    return _write(output_path, handler.transform_bundle(_read_mmap(input_path), bundle))


def untransform_file_with_handler(handler: FileFormatHandler, input_path,
                                  output_path) -> int:
    return _write(output_path, handler.untransform(_read_mmap(input_path)))


def transform_file_with_multiple_handlers(handlers: Iterable[FileFormatHandler],
                                          bundle: TransformBundle, input_path,
                                          output_path,
                                          file_extension: Optional[str] = None) -> int:
    return _write(output_path, transform_slice_with_multiple_handlers(
        handlers, _read_mmap(input_path), bundle, file_extension))


def untransform_file_with_multiple_handlers(handlers: Iterable[FileFormatHandler],
                                            input_path, output_path,
                                            file_extension: Optional[str] = None) -> int:
    return _write(output_path, untransform_slice_with_multiple_handlers(
        handlers, _read_mmap(input_path), file_extension))
