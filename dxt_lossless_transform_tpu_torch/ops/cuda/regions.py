"""Candidate-region kernels (``dlt_bc1_regions`` in ``csrc/bc1_kernels.cu``,
``dlt_bc2_regions`` in ``csrc/bc2_kernels.cu``, ``dlt_bc3_regions`` in
``csrc/bc3_kernels.cu``) and their plain versions.

``dlt_bc1_regions`` replaces ``dxt_lossless_transform_tpu/ops/pallas/regions.py:60``
``bc1_region_streams_tpu``. For BC1 blocks (uint8[8n]) and candidates
``((variant, split), ...)``, row c of the uint8[C, 4n] result is the colour region
that candidate c's transform writes at ``[0, 4n)``: the decorrelated colour words,
or the c0 stream followed by the c1 stream with no gap. These are the rows that
``dxt_lossless_transform_tpu/ops/auto.py:bc1_candidate_regions`` builds, cut to 4n.

``dlt_bc2_regions`` replaces ``:83`` ``bc2_region_streams_tpu``. For BC2 blocks
(uint8[16n]) and distinct keys ``((variant, split), ...)``, row c of the uint8[K, 4n]
result is the colour stream that key c's transform writes at ``[8n, 12n)``, built from
word 2 of each block: the rows of
``dxt_lossless_transform_tpu/ops/auto.py:bc2_candidate_regions`` cut to 4n, without
repeats.

``dlt_bc3_regions`` replaces ``:114`` ``bc3_region_streams_tpu``. For BC3 blocks
(uint8[16n]) it writes one alpha-endpoint row (uint8[2n], the bytes at ``[0, 2n)`` of
the transform) per distinct ``split_alpha`` value and one colour row (uint8[4n], the
bytes at ``[8n, 12n)``) per distinct ``(variant, split_colour)`` pair: the rows of
``dxt_lossless_transform_tpu/ops/auto.py:bc3_candidate_regions`` without repeats.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ... import backend
from .. import ycocg
from .shuffle import _check_blocks, write_colours, write_endpoints

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


def colour_rows_plain(colours: torch.Tensor, candidates) -> torch.Tensor:
    """int32 colour words (n) -> uint8[C, 4n] colour regions, in candidate order."""
    dec = {v: ycocg.decorrelate_pair(colours, v) for v, _ in candidates}
    out = torch.empty((len(candidates), colours.numel() * 4), dtype=torch.uint8,
                      device=colours.device)
    for row, (v, split) in zip(out, candidates):
        write_colours(row, dec[v], split)
    return out


def bc1_regions_plain(x: torch.Tensor, candidates) -> torch.Tensor:
    return colour_rows_plain(x.view(torch.int32).view(-1, 2)[:, 0], candidates)


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


def bc2_regions_plain(x: torch.Tensor, candidates) -> torch.Tensor:
    return colour_rows_plain(x.view(torch.int32).view(-1, 4)[:, 2], candidates)


def bc2_regions(x: torch.Tensor, candidates) -> torch.Tensor:
    """BC2 blocks (uint8[16n]) -> uint8[K, 4n] colour regions, in key order."""
    n = _check_blocks(x, "bc2_regions", 16)
    cand = _check_candidates(candidates)
    if not backend.dispatch(x):
        return bc2_regions_plain(x, cand)
    backend.require_cuda_tensor(x, "bc2_regions", torch.uint8, align=16)
    out = torch.empty((len(cand), 4 * n), dtype=torch.uint8, device=x.device)
    if n:
        backend.launch("dlt_bc2_regions", x.device, x.data_ptr(), out.data_ptr(), n,
                       candidate_code(cand), len(cand))
    return out


def _check_alpha_keys(alpha_keys) -> Tuple[bool, ...]:
    keys = tuple(bool(sa) for sa in alpha_keys)
    if not 0 < len(keys) <= 2 or len(set(keys)) != len(keys):
        raise ValueError(f"expected 1-2 distinct split_alpha keys, got {alpha_keys!r}")
    return keys


def bc3_regions_plain(x: torch.Tensor, alpha_keys, colour_keys):
    n = x.numel() // 16
    blocks = x.view(n, 16)
    alpha = torch.empty((len(alpha_keys), 2 * n), dtype=torch.uint8, device=x.device)
    for row, split in zip(alpha, alpha_keys):
        write_endpoints(row, blocks, split)
    colour = colour_rows_plain(x.view(torch.int32).view(n, 4)[:, 2], colour_keys)
    return alpha, colour


def bc3_regions(x: torch.Tensor, alpha_keys, colour_keys):
    """BC3 blocks (uint8[16n]) -> (uint8[A, 2n] alpha-endpoint rows, one per
    ``alpha_keys`` entry (split_alpha), uint8[K, 4n] colour rows, one per
    ``colour_keys`` entry ((variant, split_colour)))."""
    n = _check_blocks(x, "bc3_regions", 16)
    akeys = _check_alpha_keys(alpha_keys)
    ckeys = _check_candidates(colour_keys)
    if not backend.dispatch(x):
        return bc3_regions_plain(x, akeys, ckeys)
    backend.require_cuda_tensor(x, "bc3_regions", torch.uint8, align=16)
    alpha = torch.empty((len(akeys), 2 * n), dtype=torch.uint8, device=x.device)
    colour = torch.empty((len(ckeys), 4 * n), dtype=torch.uint8, device=x.device)
    if n:
        alpha_code = sum(1 << a for a, split in enumerate(akeys) if split)
        backend.launch("dlt_bc3_regions", x.device, x.data_ptr(), alpha.data_ptr(),
                       colour.data_ptr(), n, alpha_code, len(akeys),
                       candidate_code(ckeys), len(ckeys))
    return alpha, colour
