"""RGBA8888, BGRA8888 and BGR888 transforms, untransforms and the auto-search, bytes
to bytes, on the device.

Counterpart of ``dxt_lossless_transform_tpu/ops/rgb.py``; the layouts are those of
``oracle/rgb.py``: with ``decorrelate``, r' = r - g and b' = b - g (mod 256); with
``split_channels``, one plane per channel (``[c0 x n][c1 x n]...``); both off is the
identity. The identity returns the payload without a launch, as the JAX package's
host route does; every other setting is one kernel launch
(:mod:`.cuda.channels`) on the payload copied to the device once, at the exact
pixel count: nothing is padded.

The auto-search follows ``transform_rgb_auto`` (JAX ``ops/rgb.py:180-191``): each
distinct candidate's whole transformed stream is one row of a (K, S·n) tensor,
written there by one transform launch (the identity's row is a copy of the
payload), the rows are scored in one call where they lie, ties go to the first
candidate, and only the winner's row comes back. As in the JAX package, an empty
payload gives ``(b"", last candidate)`` whatever its layout, a length that is not a
whole number of pixels raises :class:`RgbValidationError` (also below one pixel),
``use_all_decorrelation_modes`` changes nothing, and an estimator's error is not
wrapped.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import backend
from ..errors import RgbValidationError
from ..estimate.base import SizeEstimation
from ..settings import RGB_FAST_CANDIDATES, RgbTransformSettings
from .auto import distinct
from .cuda import channels
from .cuda.channels import LAYOUTS  # noqa: F401  (re-exported)


def _is_identity(settings: RgbTransformSettings) -> bool:
    return not settings.decorrelate and not settings.split_channels


def _stride(data, layout: str) -> int:
    """The layout's pixel size; raises for a length that is not a whole number of
    pixels."""
    stride = LAYOUTS[layout][0]
    if len(data) % stride:
        raise RgbValidationError(layout, len(data), stride)
    return stride


def transform_tensor(x: torch.Tensor, layout: str, settings: RgbTransformSettings,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pixels (uint8[S·n], on any device) -> the transformed bytes; the identity
    returns ``x`` itself (``out`` is then not written)."""
    if _is_identity(settings):
        return x
    return channels.rgb_transform(x, *LAYOUTS[layout], settings.decorrelate,
                                  settings.split_channels, out=out)


def untransform_tensor(x: torch.Tensor, layout: str,
                       settings: RgbTransformSettings) -> torch.Tensor:
    """Inverse of :func:`transform_tensor`."""
    if _is_identity(settings):
        return x
    return channels.rgb_untransform(x, *LAYOUTS[layout], settings.decorrelate,
                                    settings.split_channels)


def transform(data, layout: str,
              settings: RgbTransformSettings = RgbTransformSettings(),
              device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved pixels -> the decorrelated and/or planar layout."""
    _stride(data, layout)
    dev = backend.resolve_device(device)
    if len(data) == 0 or _is_identity(settings):
        return bytes(data)
    return backend.download(transform_tensor(backend.upload(data, dev), layout,
                                             settings))


def untransform(data, layout: str,
                settings: RgbTransformSettings = RgbTransformSettings(),
                device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform`."""
    _stride(data, layout)
    dev = backend.resolve_device(device)
    if len(data) == 0 or _is_identity(settings):
        return bytes(data)
    return backend.download(untransform_tensor(backend.upload(data, dev), layout,
                                               settings))


def candidate_rows(x: torch.Tensor, layout: str, estimator: SizeEstimation,
                   candidates: Sequence[RgbTransformSettings]) -> tuple:
    """``(scores, rows)``: each candidate's score on its whole transformed stream,
    and the stream (a device row) of each distinct ``(decorrelate, split_channels)``
    key."""
    keys, index = distinct([(c.decorrelate, c.split_channels) for c in candidates])
    rows = torch.empty((len(keys), x.numel()), dtype=torch.uint8, device=x.device)
    for row, (dec, split) in zip(rows, keys):
        if dec or split:
            channels.rgb_transform(x, *LAYOUTS[layout], dec, split, out=row)
        else:
            row.copy_(x)
    scores = estimator.estimate_batch_device(rows, x.numel()).cpu().numpy()
    return scores[index], dict(zip(keys, rows))


def transform_rgb_auto(data, layout: str, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[RgbTransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the pixel layout whose whole transformed stream the estimator ranks
    smallest; the identity is a candidate. Returns ``(transformed, settings)``."""
    cand = tuple(candidates) if candidates is not None else RGB_FAST_CANDIDATES
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b"", cand[-1]
    _stride(data, layout)
    x = backend.upload(data, dev)
    scores, rows = candidate_rows(x, layout, estimator, cand)
    best = cand[int(np.argmin(scores))]
    if _is_identity(best):
        return bytes(data), best
    return backend.download(rows[best.decorrelate, best.split_channels]), best
