"""BC3 transform and untransform, bytes to bytes, on the device.

Counterpart of ``dxt_lossless_transform_tpu/ops/bc3.py:114-149`` with its host
wrapper's stream layout (``ops/hostwrap.py:bc3_stream_spec``: alpha endpoints as
one u16 stream or two u8 streams, the 6-byte alpha-index stream, colours as one u32
stream or two u16 streams, the colour-index stream). The payload goes to the device
in one copy through a pinned host buffer, one kernel launch writes every stream of
the whole payload at its on-disk offset, and the bytes come back the same way.
Every payload takes this route: the JAX package's host path for payloads under
``DLT_DEVICE_MIN_BYTES`` and its TPU chunking and padding to power-of-two buckets
are not carried over.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import backend
from ..errors import Bc3ValidationError
from ..settings import Bc3TransformSettings
from .cuda import shuffle

BLOCK_SIZE = 16


def _check_len(data) -> None:
    if len(data) % BLOCK_SIZE:
        raise Bc3ValidationError(len(data), BLOCK_SIZE)


def _args(settings: Bc3TransformSettings) -> tuple:
    return (int(settings.decorrelation_mode), settings.split_alpha_endpoints,
            settings.split_colour_endpoints)


def transform_tensor(x: torch.Tensor, settings: Bc3TransformSettings) -> torch.Tensor:
    """BC3 blocks (uint8[16n], on any device) -> transformed bytes."""
    return shuffle.bc3_transform(x, *_args(settings))


def transform(data, settings: Bc3TransformSettings = Bc3TransformSettings(),
              device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved BC3 blocks -> the transformed stream layout."""
    _check_len(data)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b""
    return backend.download(transform_tensor(backend.upload(data, dev), settings))


def untransform(data, settings: Bc3TransformSettings = Bc3TransformSettings(),
                device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform`."""
    _check_len(data)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b""
    x = backend.upload(data, dev)
    return backend.download(shuffle.bc3_untransform(x, *_args(settings)))
