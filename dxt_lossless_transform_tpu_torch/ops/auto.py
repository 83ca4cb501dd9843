"""Auto-search: build every candidate's estimation regions, score them in one call
per region kind, transform with the argmin.

Counterpart of ``dxt_lossless_transform_tpu/ops/auto.py:183-211``
(``transform_bc1_auto``) and ``:241-275`` (``transform_bc3_auto``). The payload is
copied to the device once; one region-kernel launch writes the candidate regions,
the estimator scores them where they lie, and the winner's transform runs on the
payload that is already there. Ties go to the first candidate in order, as
``np.argmin`` gives them. An input shorter than one block gives empty output and
the last candidate, as in the reference.

- BC1: a candidate's region is the colour half of its output, as in the reference
  (``bc1/src/transform/transform_auto.rs:248-256``).
- BC3: a candidate's score is the sum of two regions' scores, its alpha-endpoint
  stream (2n bytes) and its colour stream (4n bytes). The region kernel writes one
  alpha row per distinct ``split_alpha`` and one colour row per distinct
  ``(variant, split_colour)``, and each candidate's score is read back from its
  two rows: identical rows score identically, so the picks equal those over the
  reference's one row per candidate.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import backend
from ..errors import AutoTransformError, Bc1ValidationError, Bc3ValidationError
from ..estimate.base import SizeEstimation
from ..settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES,
    BC3_FAST_CANDIDATES, Bc1TransformSettings, Bc3TransformSettings,
)
from . import bc1 as ops_bc1, bc3 as ops_bc3
from .cuda import regions as cuda_regions


def _key(candidates) -> tuple:
    return tuple((int(c.decorrelation_mode), c.split_colour_endpoints)
                 for c in candidates)


def _score(fmt: str, estimator: SizeEstimation, rows: torch.Tensor,
           valid_len: int) -> np.ndarray:
    """Exact scores of ``rows`` as int64, computed on their device. An estimator's
    failure is an :class:`AutoTransformError`, as in the reference."""
    try:
        scores = estimator.estimate_batch_device(rows, valid_len)
    except AutoTransformError:
        raise
    except Exception as exc:
        raise AutoTransformError(fmt, f"estimator raised {exc!r}") from exc
    return scores.cpu().numpy().astype(np.int64)


def _start(data, block_size: int, error, device) -> Optional[torch.device]:
    """Check the length and resolve the device; None for an input shorter than one
    block."""
    if len(data) >= block_size and len(data) % block_size:
        raise error(len(data), block_size)
    dev = backend.resolve_device(device)
    return dev if len(data) >= block_size else None


def candidate_scores(x: torch.Tensor, estimator: SizeEstimation,
                     candidates: Sequence[Bc1TransformSettings]) -> np.ndarray:
    """Scores of each BC1 candidate for blocks ``x`` (uint8[8n], n >= 1), computed
    on ``x``'s device."""
    rows = cuda_regions.bc1_regions(x, _key(candidates))
    return _score("BC1", estimator, rows, rows.shape[1])


def transform_bc1_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc1TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the best BC1 settings; returns ``(transformed, settings)``."""
    cand = tuple(candidates if candidates is not None else
                 (BC1_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
                  else BC1_FAST_CANDIDATES))
    dev = _start(data, ops_bc1.BLOCK_SIZE, Bc1ValidationError, device)
    if dev is None:
        return b"", cand[-1]
    x = backend.upload(data, dev)
    best = cand[int(np.argmin(candidate_scores(x, estimator, cand)))]
    return backend.download(ops_bc1.transform_tensor(x, best)), best


def bc3_keys(candidates: Sequence[Bc3TransformSettings]) -> tuple:
    """``(alpha_keys, colour_keys, alpha_index, colour_index)``: the distinct
    split_alpha values and (variant, split_colour) pairs in order of first use, and
    for each candidate the index of its alpha row and of its colour row."""
    alpha = [c.split_alpha_endpoints for c in candidates]
    colour = [(int(c.decorrelation_mode), c.split_colour_endpoints)
              for c in candidates]
    alpha_keys, colour_keys = tuple(dict.fromkeys(alpha)), tuple(dict.fromkeys(colour))
    return (alpha_keys, colour_keys, [alpha_keys.index(a) for a in alpha],
            [colour_keys.index(c) for c in colour])


def bc3_candidate_scores(x: torch.Tensor, estimator: SizeEstimation,
                         candidates: Sequence[Bc3TransformSettings]) -> np.ndarray:
    """Scores of each BC3 candidate for blocks ``x`` (uint8[16n], n >= 1): its
    alpha row's score plus its colour row's, as exact int64."""
    alpha_keys, colour_keys, ai, ci = bc3_keys(candidates)
    alpha, colour = cuda_regions.bc3_regions(x, alpha_keys, colour_keys)
    n = x.numel() // ops_bc3.BLOCK_SIZE
    a = _score("BC3", estimator, alpha, 2 * n)
    c = _score("BC3", estimator, colour, 4 * n)
    return a[ai] + c[ci]


def transform_bc3_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc3TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the best BC3 settings; returns ``(transformed, settings)``."""
    cand = tuple(candidates if candidates is not None else
                 (BC3_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
                  else BC3_FAST_CANDIDATES))
    dev = _start(data, ops_bc3.BLOCK_SIZE, Bc3ValidationError, device)
    if dev is None:
        return b"", cand[-1]
    x = backend.upload(data, dev)
    best = cand[int(np.argmin(bc3_candidate_scores(x, estimator, cand)))]
    return backend.download(ops_bc3.transform_tensor(x, best)), best
