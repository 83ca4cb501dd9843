"""BC1 candidate-region kernel (``dlt_bc1_regions`` in ``csrc/bc1_kernels.cu``) and
its plain version.

Replaces ``dxt_lossless_transform_tpu/ops/pallas/regions.py:60``
``bc1_region_streams_tpu``. For BC1 blocks (uint8[8n]) and candidates
``((variant, split), ...)``, row c of the uint8[C, 4n] result is the colour region
that candidate c's transform writes at ``[0, 4n)``: the decorrelated colour words,
or the c0 stream followed by the c1 stream with no gap. These are the rows that
``dxt_lossless_transform_tpu/ops/auto.py:bc1_candidate_regions`` builds, cut to 4n.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ... import backend
from .. import ycocg
from .shuffle import _check_blocks, write_colours

MAX_CANDIDATES = 8


def _check_candidates(candidates) -> Tuple[Tuple[int, bool], ...]:
    cand = tuple((int(v), bool(s)) for v, s in candidates)
    if not 0 < len(cand) <= MAX_CANDIDATES or any(v not in (0, 1, 2, 3)
                                                  for v, _ in cand):
        raise ValueError(f"expected 1-{MAX_CANDIDATES} (variant 0-3, split) "
                         f"candidates, got {candidates!r}")
    return cand


def candidate_code(candidates: Sequence[Tuple[int, bool]]) -> int:
    """The kernel's encoding: 4 bits per candidate, variant in bits 0-1, split bit 2."""
    code = 0
    for c, (v, split) in enumerate(candidates):
        code |= (v | (4 if split else 0)) << (4 * c)
    return code


def bc1_regions_plain(x: torch.Tensor, candidates) -> torch.Tensor:
    colours = x.view(torch.int32).view(-1, 2)[:, 0]
    dec = {v: ycocg.decorrelate_pair(colours, v) for v, _ in candidates}
    out = torch.empty((len(candidates), colours.numel() * 4), dtype=torch.uint8,
                      device=x.device)
    for row, (v, split) in zip(out, candidates):
        write_colours(row, dec[v], split)
    return out


def bc1_regions(x: torch.Tensor, candidates) -> torch.Tensor:
    """BC1 blocks (uint8[8n]) -> uint8[C, 4n] colour regions, in candidate order."""
    n = _check_blocks(x, "bc1_regions")
    cand = _check_candidates(candidates)
    if not backend.dispatch(x):
        return bc1_regions_plain(x, cand)
    backend.require_cuda_tensor(x, "bc1_regions", torch.uint8, align=8)
    out = torch.empty((len(cand), 4 * n), dtype=torch.uint8, device=x.device)
    if n:
        backend.launch("dlt_bc1_regions", x.device, x.data_ptr(), out.data_ptr(), n,
                       candidate_code(cand), len(cand))
    return out
