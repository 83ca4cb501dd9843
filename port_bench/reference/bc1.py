"""Plain PyTorch reference of the BC1 transform, its inverse, and the corpus batch's
auto-search over the FAST candidates.

Block (8 bytes, little-endian): colour0 u16, colour1 u16, 16 two-bit indices u32.
Transformed payload of n blocks: the colour section, then the indices (u32 x n).
The colour section holds each block's colour word ``c0 | c1 << 16`` with both halves
decorrelated by the variant, as u32 x n, or split: every c0 (u16 x n), then every c1.

Search (the batch step's rule, which for BC1 is also the per-file rule): each
candidate's score is the LTU score of its colour section, 4n bytes; the file ships
under the first candidate of least score.

A candidate is a dict of the settings' field names, as the 4-byte transform header
carries them: bits 0-3 the format tag (BC1: 0), then from bit 4 the format's data:
bits 0-1 version 0, bit 2 split colour endpoints, bits 3-4 the variant's code
(variant 1: 0, 2: 1, 3: 2, none: 3).
"""

from __future__ import annotations

import torch

from . import common

BLOCK_SIZE = 8
FORMAT_TAG = 0
# (decorrelation_mode, split_colour_endpoints): the FAST list, most likely winner last
FAST = tuple({"decorrelation_mode": v, "split_colour_endpoints": s}
             for v, s in ((0, False), (0, True), (1, False), (1, True)))
# every combination (the reference's round-trip tests)
ALL = tuple({"decorrelation_mode": v, "split_colour_endpoints": s}
            for v in (0, 1, 2, 3) for s in (False, True))
_VARIANT_CODE = {1: 0, 2: 1, 3: 2, 0: 3}


def header(settings: dict) -> int:
    data = (int(settings["split_colour_endpoints"]) << 2) | \
        (_VARIANT_CODE[settings["decorrelation_mode"]] << 3)
    return FORMAT_TAG | (data << 4)


def settings_of(word: int) -> dict:
    """The settings a transform header word carries (the inverse of :func:`header`)."""
    if word & 0xF != FORMAT_TAG or (word >> 4) & 0x3:
        raise ValueError(f"not a BC1 transform header: {word:#x}")
    data = word >> 4
    codes = {c: v for v, c in _VARIANT_CODE.items()}
    return {"decorrelation_mode": codes[(data >> 3) & 0x3],
            "split_colour_endpoints": bool((data >> 2) & 1)}


def colour_section(payload: torch.Tensor, settings: dict) -> torch.Tensor:
    """The transformed colour section (4n bytes) of the uint8 ``payload``."""
    c = common.lanes(payload, 2, 4)[:, :2]          # (n, 2): colour0, colour1
    v = settings["decorrelation_mode"]
    c0, c1 = common.decorrelate(c[:, 0], v), common.decorrelate(c[:, 1], v)
    if settings["split_colour_endpoints"]:
        return torch.cat([common.to_bytes(c0, 2), common.to_bytes(c1, 2)])
    return common.to_bytes(c0 | (c1 << 16), 4)


def transform(payload: torch.Tensor, settings: dict) -> torch.Tensor:
    idx = payload.view(-1, BLOCK_SIZE)[:, 4:].reshape(-1)
    return torch.cat([colour_section(payload, settings), idx])


def untransform(data: torch.Tensor, settings: dict) -> torch.Tensor:
    """Inverse of :func:`transform` (the reference's own round-trip tests)."""
    n = data.numel() // BLOCK_SIZE
    colours, idx = data[:4 * n], data[4 * n:]
    if settings["split_colour_endpoints"]:
        c0 = common.lanes(colours[:2 * n], 2, 1)[:, 0]
        c1 = common.lanes(colours[2 * n:], 2, 1)[:, 0]
    else:
        c = common.lanes(colours, 2, 2)
        c0, c1 = c[:, 0], c[:, 1]
    v = settings["decorrelation_mode"]
    c0, c1 = common.recorrelate(c0, v), common.recorrelate(c1, v)
    out = torch.stack([common.to_bytes(c0, 2).view(n, 2), common.to_bytes(c1, 2).view(n, 2),
                       idx.view(n, 4)[:, :2], idx.view(n, 4)[:, 2:]], dim=1)
    return out.reshape(-1)


def sections(payload: torch.Tensor, candidates=FAST) -> list:
    """(row, valid) of each distinct scored region of ``candidates``: the rows the
    search has to build and count."""
    n = payload.numel() // BLOCK_SIZE
    keys = list(dict.fromkeys((c["decorrelation_mode"], c["split_colour_endpoints"])
                              for c in candidates))
    return [(colour_section(payload, {"decorrelation_mode": v,
                                      "split_colour_endpoints": sc}), 4 * n)
            for v, sc in keys]


def search(payload: torch.Tensor, candidates=FAST) -> tuple:
    """(index of the first candidate of least score, the scores)."""
    n = payload.numel() // BLOCK_SIZE
    scores = [common.ltu_score(colour_section(payload, c), 4 * n)
              for c in candidates]
    return scores.index(min(scores)), scores
