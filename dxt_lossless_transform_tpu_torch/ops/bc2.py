"""BC2 transform and untransform, bytes to bytes, on the device.

Counterpart of ``dxt_lossless_transform_tpu/ops/bc2.py:89-120`` with its host
wrapper's stream layout (``ops/hostwrap.py:bc2_stream_spec``: the 8-byte alpha
stream, colours as one u32 stream or two u16 streams, the colour-index stream). The
payload goes to the device in one copy through a pinned host buffer, one kernel
launch writes every stream of the whole payload at its on-disk offset, and the bytes
come back the same way. Every payload takes this route: the JAX package's host path
for payloads under ``DLT_DEVICE_MIN_BYTES`` and its TPU chunking and padding are not
carried over.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import backend
from ..errors import Bc2ValidationError
from ..settings import Bc2TransformSettings
from .cuda import shuffle

BLOCK_SIZE = 16


def _check_len(data) -> None:
    if len(data) % BLOCK_SIZE:
        raise Bc2ValidationError(len(data), BLOCK_SIZE)


def transform_tensor(x: torch.Tensor, settings: Bc2TransformSettings) -> torch.Tensor:
    """BC2 blocks (uint8[16n], on any device) -> transformed bytes."""
    return shuffle.bc2_transform(x, int(settings.decorrelation_mode),
                                 settings.split_colour_endpoints)


def transform(data, settings: Bc2TransformSettings = Bc2TransformSettings(),
              device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved BC2 blocks -> the transformed stream layout."""
    _check_len(data)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b""
    return backend.download(transform_tensor(backend.upload(data, dev), settings))


def untransform(data, settings: Bc2TransformSettings = Bc2TransformSettings(),
                device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform`."""
    _check_len(data)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b""
    x = backend.upload(data, dev)
    return backend.download(shuffle.bc2_untransform(
        x, int(settings.decorrelation_mode), settings.split_colour_endpoints))
