"""BC1 transform and untransform, bytes to bytes, on the device.

Counterpart of ``dxt_lossless_transform_tpu/ops/bc1.py:107-138`` with its host
wrapper (``ops/hostwrap.py:48-118``). The payload goes to the device in one copy
through a pinned host buffer, one kernel launch runs over all of it, and the bytes
come back the same way. Every payload takes this route: the JAX package's host path
for payloads under ``DLT_DEVICE_MIN_BYTES`` and its TPU chunking and padding are not
carried over.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import backend
from ..errors import Bc1ValidationError
from ..settings import Bc1TransformSettings
from .cuda import shuffle

BLOCK_SIZE = 8


def _check_len(data) -> None:
    if len(data) % BLOCK_SIZE:
        raise Bc1ValidationError(len(data), BLOCK_SIZE)


def transform_tensor(x: torch.Tensor, settings: Bc1TransformSettings) -> torch.Tensor:
    """BC1 blocks (uint8[8n], on any device) -> transformed bytes."""
    return shuffle.bc1_transform(x, int(settings.decorrelation_mode),
                                 settings.split_colour_endpoints)


def transform(data, settings: Bc1TransformSettings = Bc1TransformSettings(),
              device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved BC1 blocks -> the transformed stream layout."""
    _check_len(data)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b""
    return backend.download(transform_tensor(backend.upload(data, dev), settings))


def untransform(data, settings: Bc1TransformSettings = Bc1TransformSettings(),
                device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform`."""
    _check_len(data)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b""
    x = backend.upload(data, dev)
    return backend.download(shuffle.bc1_untransform(
        x, int(settings.decorrelation_mode), settings.split_colour_endpoints))
