"""Plain PyTorch reference of the BC3 auto-search under zstd level 1, the search of
the CLI's ``optimal`` preset, on both of its routes (the host-scored batch and the
per-file search).

A candidate's score is the zstd-1 size (:func:`.zstd1.size`) of its alpha-endpoint
section (2n bytes) plus that of its colour section (4n bytes), each compressed
alone; each distinct section is compressed once, and the file ships under the first
candidate of least score. The sections, the transform and the header are
:mod:`.bc3`'s.
"""

from __future__ import annotations

import torch

from . import bc3, zstd1


def search(payload: torch.Tensor, candidates=bc3.FAST) -> tuple:
    """(index of the first candidate of least zstd-1 score, the scores) of the BC3
    blocks ``payload`` (uint8, on any device)."""
    alpha = list(dict.fromkeys(c["split_alpha_endpoints"] for c in candidates))
    colour = list(dict.fromkeys((c["decorrelation_mode"], c["split_colour_endpoints"])
                                for c in candidates))
    # bc3.sections: the distinct alpha sections, then the distinct colour sections,
    # each in order of first use
    sizes = [zstd1.size(row[:valid].cpu().numpy())
             for row, valid in bc3.sections(payload, candidates)]
    scores = [sizes[alpha.index(c["split_alpha_endpoints"])]
              + sizes[len(alpha) + colour.index((c["decorrelation_mode"],
                                                 c["split_colour_endpoints"]))]
              for c in candidates]
    return scores.index(min(scores)), scores
