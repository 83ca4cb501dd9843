"""BC1 auto-search: build every candidate's colour region, score all of them in one
call, transform with the argmin.

Counterpart of ``dxt_lossless_transform_tpu/ops/auto.py:183-211``
(``transform_bc1_auto``). The payload is copied to the device once; the region
kernel writes the (C, 4n) candidate regions, the estimator scores them where they
lie, and the winner's transform runs on the payload that is already there. The
estimation region is the colour half of each candidate's output, as in the
reference (``bc1/src/transform/transform_auto.rs:248-256``). Ties go to the first
candidate in order, as ``np.argmin`` gives them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import backend
from ..errors import AutoTransformError, Bc1ValidationError
from ..estimate.base import SizeEstimation
from ..settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, Bc1TransformSettings,
)
from . import bc1 as ops_bc1
from .cuda import regions as cuda_regions


def _key(candidates) -> tuple:
    return tuple((int(c.decorrelation_mode), c.split_colour_endpoints)
                 for c in candidates)


def candidate_scores(x: torch.Tensor, estimator: SizeEstimation,
                     candidates: Sequence[Bc1TransformSettings]) -> np.ndarray:
    """Scores of each candidate for BC1 blocks ``x`` (uint8[8n], n >= 1), computed
    on ``x``'s device. An estimator's failure is an :class:`AutoTransformError`,
    as in the reference."""
    regions = cuda_regions.bc1_regions(x, _key(candidates))
    try:
        scores = estimator.estimate_batch_device(regions, regions.shape[1])
    except AutoTransformError:
        raise
    except Exception as exc:
        raise AutoTransformError("BC1", f"estimator raised {exc!r}") from exc
    return scores.cpu().numpy()


def transform_bc1_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc1TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the best BC1 settings; returns ``(transformed, settings)``."""
    cand = tuple(candidates if candidates is not None else
                 (BC1_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
                  else BC1_FAST_CANDIDATES))
    if len(data) % ops_bc1.BLOCK_SIZE:
        raise Bc1ValidationError(len(data), ops_bc1.BLOCK_SIZE)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b"", cand[-1]
    x = backend.upload(data, dev)
    best = cand[int(np.argmin(candidate_scores(x, estimator, cand)))]
    return backend.download(ops_bc1.transform_tensor(x, best)), best
