"""BC4 and BC5 transforms, untransforms and auto-searches, bytes to bytes, on the
device.

Counterpart of ``dxt_lossless_transform_tpu/ops/bc45.py:118-194``; the layouts are
those of ``oracle/bc4.py`` (stream specs ``(2, 6)``/``(1, 1, 6)`` for BC4 and
``(2, 2, 6, 6)``/``(1, 1, 1, 1, 6, 6)`` for BC5, ``ops/bc45.py:108-113``). The
payload goes to the device in one copy through a pinned host buffer, one kernel
launch writes every stream at its on-disk offset, and the bytes come back the same
way.

The auto-search scores each candidate (``split_endpoints`` true or false) on its
endpoint streams: 2n bytes for BC4, 4n for BC5 (red's then green's). The JAX package
builds those rows on the host; they are the first bytes of the candidate's own
transformed output, so here the payload is transformed on the device once per
distinct candidate, the prefixes are scored as one (K, L) tensor, and the winner's
output is the one kept: K transform launches, one scoring call and no further
transform. Ties go to the first candidate in order. An input shorter than one block
gives empty output and the last candidate, as in the reference; a longer input that
is not a whole number of blocks raises :class:`AutoTransformError`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import backend
from ..errors import Bc4ValidationError, Bc5ValidationError
from ..estimate.base import SizeEstimation
from ..settings import Bc4TransformSettings, Bc5TransformSettings
from .auto import distinct, score, start
from .cuda import shuffle

BC4_BLOCK_SIZE = 8
BC5_BLOCK_SIZE = 16


def _bytes_op(data, block_size: int, error, device, kernel, split: bool) -> bytes:
    """Check the length, upload, run ``kernel(x, split)`` and download."""
    if len(data) % block_size:
        raise error(len(data), block_size)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b""
    return backend.download(kernel(backend.upload(data, dev), split))


def transform_bc4_tensor(x: torch.Tensor, settings: Bc4TransformSettings) -> torch.Tensor:
    """BC4 blocks (uint8[8n], on any device) -> transformed bytes."""
    return shuffle.bc4_transform(x, settings.split_endpoints)


def transform_bc5_tensor(x: torch.Tensor, settings: Bc5TransformSettings) -> torch.Tensor:
    """BC5 blocks (uint8[16n], on any device) -> transformed bytes."""
    return shuffle.bc5_transform(x, settings.split_endpoints)


def transform_bc4(data, settings: Bc4TransformSettings = Bc4TransformSettings(),
                  device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved BC4 blocks -> the transformed stream layout."""
    return _bytes_op(data, BC4_BLOCK_SIZE, Bc4ValidationError, device,
                     shuffle.bc4_transform, settings.split_endpoints)


def untransform_bc4(data, settings: Bc4TransformSettings = Bc4TransformSettings(),
                    device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform_bc4`."""
    return _bytes_op(data, BC4_BLOCK_SIZE, Bc4ValidationError, device,
                     shuffle.bc4_untransform, settings.split_endpoints)


def transform_bc5(data, settings: Bc5TransformSettings = Bc5TransformSettings(),
                  device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved BC5 blocks -> the transformed stream layout."""
    return _bytes_op(data, BC5_BLOCK_SIZE, Bc5ValidationError, device,
                     shuffle.bc5_transform, settings.split_endpoints)


def untransform_bc5(data, settings: Bc5TransformSettings = Bc5TransformSettings(),
                    device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform_bc5`."""
    return _bytes_op(data, BC5_BLOCK_SIZE, Bc5ValidationError, device,
                     shuffle.bc5_untransform, settings.split_endpoints)


def bc4_spec(split: bool) -> Tuple[int, ...]:
    """Bytes per block of each BC4 stream, in on-disk order (JAX ``ops/bc45.py:108``
    ``_bc4_spec``)."""
    return (1, 1, 6) if split else (2, 6)


def bc5_spec(split: bool) -> Tuple[int, ...]:
    """Bytes per block of each BC5 stream, in on-disk order (JAX ``ops/bc45.py:112``
    ``_bc5_spec``)."""
    return (1, 1, 1, 1, 6, 6) if split else (2, 2, 6, 6)


def endpoint_scores(fmt: str, x: torch.Tensor, estimator: SizeEstimation,
                    candidates, endpoint_bytes: int, transform) -> tuple:
    """``(scores, outputs)``: each candidate's score on the first ``endpoint_bytes``
    of its transformed output, and the outputs of the distinct candidates by
    ``split_endpoints``."""
    keys, index = distinct([c.split_endpoints for c in candidates])
    outputs = {split: transform(x, split) for split in keys}
    rows = torch.stack([outputs[split][:endpoint_bytes] for split in keys])
    return score(fmt, estimator, rows, endpoint_bytes)[index], outputs


def _auto(fmt: str, data, estimator: SizeEstimation, candidates, all_candidates,
          block_size: int, endpoint_bytes_per_block: int, transform, device):
    cand = tuple(candidates if candidates is not None else all_candidates())
    dev = start(fmt, data, block_size, device)
    if dev is None:
        return b"", cand[-1]
    x = backend.upload(data, dev)
    n = len(data) // block_size
    scores, outputs = endpoint_scores(fmt, x, estimator, cand,
                                      endpoint_bytes_per_block * n, transform)
    best = cand[int(np.argmin(scores))]
    return backend.download(outputs[best.split_endpoints]), best


def transform_bc4_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc4TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the BC4 endpoint layout whose endpoint stream the estimator ranks
    smallest; returns ``(transformed, settings)``. ``use_all_decorrelation_modes``
    is accepted for the builders' sake and changes nothing: BC4 has no
    decorrelation."""
    return _auto("BC4", data, estimator, candidates,
                 Bc4TransformSettings.all_combinations, BC4_BLOCK_SIZE, 2,
                 shuffle.bc4_transform, device)


def transform_bc5_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc5TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the BC5 endpoint layout whose endpoint streams (red's then green's) the
    estimator ranks smallest; returns ``(transformed, settings)``."""
    return _auto("BC5", data, estimator, candidates,
                 Bc5TransformSettings.all_combinations, BC5_BLOCK_SIZE, 4,
                 shuffle.bc5_transform, device)
