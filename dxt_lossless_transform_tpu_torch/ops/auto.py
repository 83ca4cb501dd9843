"""Auto-search: build every candidate's estimation regions, score them in one call
per region kind, transform with the argmin.

Counterpart of ``dxt_lossless_transform_tpu/ops/auto.py:183-211``
(``transform_bc1_auto``), ``:212-238`` (``transform_bc2_auto``) and ``:241-275``
(``transform_bc3_auto``); the BC4 and BC5 searches are in :mod:`.bc45`. The payload
is copied to the device once; one region-kernel launch writes the candidate
regions, the estimator scores them where they lie, and the winner's transform runs
on the payload that is already there. Ties go to the first candidate in order, as
``np.argmin`` gives them. An input shorter than one block gives empty output and
the last candidate, as in the reference; a longer input that is not a whole number
of blocks raises :class:`AutoTransformError`.

The region kernels write one row per distinct key, and each candidate's score is
read back from its row(s): identical rows score identically, so the picks equal
those over the reference's one row per candidate, repeated candidates included.

- BC1: a candidate's region is the colour half of its output, as in the reference
  (``bc1/src/transform/transform_auto.rs:248-256``); one row per distinct
  ``(variant, split)``.
- BC2: the colour stream at ``[8n, 12n)`` of its output (``bc2 ..:252-254``); one row
  per distinct ``(variant, split)``.
- BC3: a candidate's score is the sum of two regions' scores, its alpha-endpoint
  stream (2n bytes) and its colour stream (4n bytes): one alpha row per distinct
  ``split_alpha`` and one colour row per distinct ``(variant, split_colour)``, both
  kinds handed to the estimator in one call (:func:`score_parts`), so that a host
  estimator compresses all of a file's rows at once.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import backend
from ..errors import AutoTransformError
from ..estimate.base import SizeEstimation
from ..utils.profiling import span
from ..settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
    BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
)
from . import bc1 as ops_bc1, bc2 as ops_bc2, bc3 as ops_bc3
from .cuda import regions as cuda_regions


def distinct(keys: Sequence) -> tuple:
    """``(distinct_keys, index)``: the distinct keys in order of first use, and for
    each key its position among them."""
    unique = tuple(dict.fromkeys(keys))
    return unique, [unique.index(k) for k in keys]


def colour_keys(candidates) -> tuple:
    """:func:`distinct` of the candidates' ``(variant, split_colour)`` pairs."""
    return distinct([(int(c.decorrelation_mode), c.split_colour_endpoints)
                     for c in candidates])


def score(fmt: str, estimator: SizeEstimation, rows: torch.Tensor,
          valid_len: int) -> np.ndarray:
    """Scores of ``rows``: :func:`score_parts` of one part."""
    return score_parts(fmt, estimator, [(rows, valid_len)])[0]


def score_parts(fmt: str, estimator: SizeEstimation, parts) -> list:
    """Scores of each ``(rows, valid_len)`` part of one search, computed by the
    estimator (on their device, or on the host for a host-only estimator, every
    part's rows in one submission). An estimator's failure is an
    :class:`AutoTransformError`, as in the reference. The span ``dlt.auto.score``
    holds the estimator's call and the scores' copy to the host (for a host-only
    estimator, the rows' copy too)."""
    with span("dlt.auto.score"):
        try:
            scores = estimator.estimate_parts_device(parts)
        except AutoTransformError:
            raise
        except Exception as exc:
            raise AutoTransformError(fmt, f"estimator raised {exc!r}") from exc
        scores = [s.cpu().numpy() for s in scores]
    return [s if s.dtype.kind == "f" else s.astype(np.int64) for s in scores]


def start(fmt: str, data, block_size: int, device) -> Optional[torch.device]:
    """Check the length and resolve the device; None for an input shorter than one
    block."""
    if len(data) % block_size and len(data) >= block_size:
        raise AutoTransformError(fmt, f"input length {len(data)} is not a multiple of "
                                      f"the {block_size}-byte block")
    dev = backend.resolve_device(device)
    return dev if len(data) >= block_size else None


def candidate_scores(x: torch.Tensor, estimator: SizeEstimation,
                     candidates: Sequence[Bc1TransformSettings]) -> np.ndarray:
    """Scores of each BC1 candidate for blocks ``x`` (uint8[8n], n >= 1), computed
    on ``x``'s device."""
    keys, index = colour_keys(candidates)
    rows = cuda_regions.bc1_regions(x, keys)
    return score("BC1", estimator, rows, rows.shape[1])[index]


def transform_bc1_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc1TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the best BC1 settings; returns ``(transformed, settings)``."""
    cand = tuple(candidates if candidates is not None else
                 (BC1_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
                  else BC1_FAST_CANDIDATES))
    return _auto("BC1", data, estimator, cand, device)


def bc2_candidate_scores(x: torch.Tensor, estimator: SizeEstimation,
                         candidates: Sequence[Bc2TransformSettings]) -> np.ndarray:
    """Scores of each BC2 candidate for blocks ``x`` (uint8[16n], n >= 1): its colour
    row's score."""
    keys, index = colour_keys(candidates)
    rows = cuda_regions.bc2_regions(x, keys)
    return score("BC2", estimator, rows, rows.shape[1])[index]


def transform_bc2_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc2TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the best BC2 settings; returns ``(transformed, settings)``."""
    cand = tuple(candidates if candidates is not None else
                 (BC2_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
                  else BC2_FAST_CANDIDATES))
    return _auto("BC2", data, estimator, cand, device)


def bc3_keys(candidates: Sequence[Bc3TransformSettings]) -> tuple:
    """``(alpha_keys, colour_keys, alpha_index, colour_index)``: the distinct
    split_alpha values and (variant, split_colour) pairs in order of first use, and
    for each candidate the index of its alpha row and of its colour row."""
    alpha_keys, ai = distinct([c.split_alpha_endpoints for c in candidates])
    ckeys, ci = colour_keys(candidates)
    return alpha_keys, ckeys, ai, ci


def bc3_candidate_scores(x: torch.Tensor, estimator: SizeEstimation,
                         candidates: Sequence[Bc3TransformSettings]) -> np.ndarray:
    """Scores of each BC3 candidate for blocks ``x`` (uint8[16n], n >= 1): its
    alpha row's score plus its colour row's."""
    alpha_keys, ckeys, ai, ci = bc3_keys(candidates)
    alpha, colour = cuda_regions.bc3_regions(x, alpha_keys, ckeys)
    n = x.numel() // ops_bc3.BLOCK_SIZE
    a, c = score_parts("BC3", estimator, [(alpha, 2 * n), (colour, 4 * n)])
    return a[ai] + c[ci]


def transform_bc3_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc3TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the best BC3 settings; returns ``(transformed, settings)``."""
    cand = tuple(candidates if candidates is not None else
                 (BC3_COMPREHENSIVE_CANDIDATES if use_all_decorrelation_modes
                  else BC3_FAST_CANDIDATES))
    return _auto("BC3", data, estimator, cand, device)


# each format's candidate scores and transform module
_SEARCH = {"BC1": (candidate_scores, ops_bc1), "BC2": (bc2_candidate_scores, ops_bc2),
           "BC3": (bc3_candidate_scores, ops_bc3)}


def transform_auto_tensor(fmt: str, x: torch.Tensor, estimator: SizeEstimation,
                          candidates: Sequence) -> tuple:
    """The ``fmt`` ("BC1", "BC2" or "BC3") search on blocks ``x`` (uint8, n >= 1
    blocks) where they lie: ``(the winner's output tensor, its settings)``."""
    scores, ops = _SEARCH[fmt]
    best = candidates[int(np.argmin(scores(x, estimator, candidates)))]
    return ops.transform_tensor(x, best), best


def _auto(fmt: str, data, estimator: SizeEstimation, cand: tuple, device) -> tuple:
    """:func:`transform_auto_tensor` on ``data`` uploaded once; ``(bytes, settings)``.
    Counts the searched payloads' bytes in ``auto.payload_bytes``."""
    dev = start(fmt, data, _SEARCH[fmt][1].BLOCK_SIZE, device)
    if dev is None:
        return b"", cand[-1]
    backend.count("auto.payload_bytes", len(data))
    out, best = transform_auto_tensor(fmt, backend.upload(data, dev), estimator, cand)
    return backend.download(out), best
