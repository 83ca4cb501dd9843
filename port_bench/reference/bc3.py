"""Plain PyTorch reference of the BC3 transform, its inverse, and the corpus batch's
auto-search over the FAST candidates.

Block (16 bytes, little-endian): alpha0 u8, alpha1 u8, 48 bits of alpha indices,
colour0 u16, colour1 u16, colour indices u32. Transformed payload of n blocks, in
this order: the alpha endpoints (u16 ``a0 | a1 << 8`` x n, or split: every a0 byte,
then every a1 byte), the alpha indices (6 bytes x n), the colour section (as BC1's:
``c0 | c1 << 16`` decorrelated, u32 x n, or split: every c0, then every c1), the
colour indices (u32 x n).

Search (the batch step's rule, from the JAX package's ``parallel/sharded.py``
``_bc3_batched_impl``): a candidate's score is the LTU score of its alpha-endpoint
section (2n bytes) plus that of its colour section (4n bytes), each scored alone;
the file ships under the first candidate of least score.

Header: format tag 2, data bits as BC1's, and bit 5 split alpha endpoints.
"""

from __future__ import annotations

import torch

from . import common

BLOCK_SIZE = 16
FORMAT_TAG = 2
FAST = tuple({"decorrelation_mode": v, "split_alpha_endpoints": sa,
              "split_colour_endpoints": sc}
             for v, sa, sc in ((1, True, False), (1, True, True), (0, True, False),
                               (0, False, True), (0, True, True), (1, False, True),
                               (0, False, False), (1, False, False)))
ALL = tuple({"decorrelation_mode": v, "split_alpha_endpoints": sa,
             "split_colour_endpoints": sc}
            for v in (0, 1, 2, 3) for sa in (False, True) for sc in (False, True))
_VARIANT_CODE = {1: 0, 2: 1, 3: 2, 0: 3}


def header(settings: dict) -> int:
    data = (int(settings["split_colour_endpoints"]) << 2) | \
        (_VARIANT_CODE[settings["decorrelation_mode"]] << 3) | \
        (int(settings["split_alpha_endpoints"]) << 5)
    return FORMAT_TAG | (data << 4)


def settings_of(word: int) -> dict:
    """The settings a transform header word carries (the inverse of :func:`header`)."""
    if word & 0xF != FORMAT_TAG or (word >> 4) & 0x3:
        raise ValueError(f"not a BC3 transform header: {word:#x}")
    data = word >> 4
    codes = {c: v for v, c in _VARIANT_CODE.items()}
    return {"decorrelation_mode": codes[(data >> 3) & 0x3],
            "split_alpha_endpoints": bool((data >> 5) & 1),
            "split_colour_endpoints": bool((data >> 2) & 1)}


def alpha_section(payload: torch.Tensor, settings: dict) -> torch.Tensor:
    ep = payload.view(-1, BLOCK_SIZE)[:, :2]
    if settings["split_alpha_endpoints"]:
        return torch.cat([ep[:, 0], ep[:, 1]])
    return ep.reshape(-1)


def colour_section(payload: torch.Tensor, settings: dict) -> torch.Tensor:
    c = common.lanes(payload, 2, 8)[:, 4:6]
    v = settings["decorrelation_mode"]
    c0, c1 = common.decorrelate(c[:, 0], v), common.decorrelate(c[:, 1], v)
    if settings["split_colour_endpoints"]:
        return torch.cat([common.to_bytes(c0, 2), common.to_bytes(c1, 2)])
    return common.to_bytes(c0 | (c1 << 16), 4)


def transform(payload: torch.Tensor, settings: dict) -> torch.Tensor:
    blocks = payload.view(-1, BLOCK_SIZE)
    return torch.cat([alpha_section(payload, settings), blocks[:, 2:8].reshape(-1),
                      colour_section(payload, settings), blocks[:, 12:].reshape(-1)])


def untransform(data: torch.Tensor, settings: dict) -> torch.Tensor:
    """Inverse of :func:`transform` (the reference's own round-trip tests)."""
    n = data.numel() // BLOCK_SIZE
    alpha, aidx = data[:2 * n], data[2 * n:8 * n]
    colours, cidx = data[8 * n:12 * n], data[12 * n:]
    ep = (torch.stack([alpha[:n], alpha[n:]], dim=1)
          if settings["split_alpha_endpoints"] else alpha.view(n, 2))
    if settings["split_colour_endpoints"]:
        c0 = common.lanes(colours[:2 * n], 2, 1)[:, 0]
        c1 = common.lanes(colours[2 * n:], 2, 1)[:, 0]
    else:
        c = common.lanes(colours, 2, 2)
        c0, c1 = c[:, 0], c[:, 1]
    v = settings["decorrelation_mode"]
    c0, c1 = common.recorrelate(c0, v), common.recorrelate(c1, v)
    out = torch.cat([ep, aidx.view(n, 6), common.to_bytes(c0, 2).view(n, 2),
                     common.to_bytes(c1, 2).view(n, 2), cidx.view(n, 4)], dim=1)
    return out.reshape(-1)


def sections(payload: torch.Tensor, candidates=FAST) -> list:
    """(row, valid) of each distinct scored region of ``candidates``: the alpha
    sections, then the colour sections."""
    n = payload.numel() // BLOCK_SIZE
    alpha = dict.fromkeys(c["split_alpha_endpoints"] for c in candidates)
    colour = dict.fromkeys((c["decorrelation_mode"], c["split_colour_endpoints"])
                           for c in candidates)
    return ([(alpha_section(payload, {"split_alpha_endpoints": a}), 2 * n)
             for a in alpha]
            + [(colour_section(payload, {"decorrelation_mode": v,
                                         "split_colour_endpoints": sc}), 4 * n)
               for v, sc in colour])


def search(payload: torch.Tensor, candidates=FAST) -> tuple:
    """(index of the first candidate of least score, the scores); each distinct
    section is scored once."""
    n = payload.numel() // BLOCK_SIZE
    alpha, colour = {}, {}
    scores = []
    for c in candidates:
        a = c["split_alpha_endpoints"]
        k = (c["decorrelation_mode"], c["split_colour_endpoints"])
        if a not in alpha:
            alpha[a] = common.ltu_score(alpha_section(payload, c), 2 * n)
        if k not in colour:
            colour[k] = common.ltu_score(colour_section(payload, c), 4 * n)
        scores.append(alpha[a] + colour[k])
    return scores.index(min(scores)), scores
