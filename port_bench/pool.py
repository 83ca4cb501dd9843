"""The corpus of a configuration, made from the seed on the device in a few large
calls per size class, then copied to the host as the files a user would hold.

Blocks follow ``dxt_lossless_transform_tpu_torch/utils/testgen.py`` ``bc1_realistic``
and ``bc3_realistic`` (a sine of base colours along the chain, correlated channels,
endpoint pairs a random delta apart, eight index patterns per file; BC3 adds
mostly-opaque alpha endpoints and four alpha-index patterns), drawn with a
``torch.Generator`` instead of numpy's. Each file is one of three kinds, in the
counts the configuration's ``kinds`` shares give, so that the auto-search has
different winners to find:

- ``correlated``: the generator as it is (channels 0.8 and 0.6 of red, deltas < 24);
- ``tight``: endpoint deltas < 4;
- ``independent``: green and blue follow sines of their own, not red.

Every file is the payload of a DDS texture: one square full mip chain (every level
down to 1x1) of a size in the configuration's ``sizes``. Which file gets which kind and
where it lies in the pool are drawn from the seed; how many of each size and kind
there are is not, so every seed does the same work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from port_bench import stream

BLOCK_SIZE = {"bc1": 8, "bc3": 16}
KINDS = ("correlated", "tight", "independent")


def chain_blocks(size: int) -> int:
    """Blocks of the full mip chain of a size x size texture."""
    total, s = 0, size
    for _ in range(size.bit_length()):
        total += ((s + 3) // 4) ** 2
        s = max(s // 2, 1)
    return total


def apportion(total: int, shares) -> List[int]:
    """Split ``total`` into whole counts in proportion to ``shares`` (largest
    remainder; ties to the earlier share)."""
    weights = [float(s) for s in shares]
    exact = [total * w / sum(weights) for w in weights]
    counts = [math.floor(e) for e in exact]
    order = sorted(range(len(exact)), key=lambda i: (-(exact[i] - counts[i]), i))
    for i in order[:total - sum(counts)]:
        counts[i] += 1
    return counts


def _from_rgb(r, g, b):
    return ((r & 0xF8) << 8) | ((g & 0xFC) << 3) | (b >> 3)


def _u8(x):
    return x.clamp(0, 255).to(torch.uint8).to(torch.int64)


def _bytes(values: torch.Tensor, width: int) -> torch.Tensor:
    return torch.stack([(values >> (8 * j)) & 0xFF for j in range(width)], dim=-1)


def _bc1_words(kinds: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """(F, n, 8) block bytes of F BC1 files of n blocks; ``kinds`` (F,) indexes
    :data:`KINDS`."""
    dev, f = kinds.device, kinds.numel()
    t = torch.linspace(0, 8 * math.pi, n, device=dev, dtype=torch.float64)
    ind = (kinds == KINDS.index("independent"))[:, None]
    r = 96 + 80 * torch.sin(t) + 8 * torch.randn(f, n, generator=gen, device=dev,
                                                  dtype=torch.float64)
    g = torch.where(ind, 96 + 80 * torch.sin(1.7 * t + 1), 0.8 * r) + \
        6 * torch.randn(f, n, generator=gen, device=dev, dtype=torch.float64)
    b = torch.where(ind, 96 + 80 * torch.sin(2.3 * t + 2), 0.6 * r) + \
        6 * torch.randn(f, n, generator=gen, device=dev, dtype=torch.float64)
    r, g, b = r.clamp(0, 255), g.clamp(0, 255), b.clamp(0, 255)
    dmax = torch.where(kinds == KINDS.index("tight"), 4, 24)[:, None]
    delta = (torch.rand(f, n, generator=gen, device=dev, dtype=torch.float64)
             * dmax).floor()
    c0 = _from_rgb(_u8(r), _u8(g), _u8(b))
    c1 = _from_rgb(_u8(r - delta), _u8(g - delta), _u8(b - delta))
    patterns = torch.randint(0, 2 ** 32, (f, 8), generator=gen, device=dev)
    idx = patterns.gather(1, torch.randint(0, 8, (f, n), generator=gen, device=dev))
    return torch.cat([_bytes(c0, 2), _bytes(c1, 2), _bytes(idx, 4)], dim=-1)


def _bc3_words(kinds: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """(F, n, 16) block bytes of F BC3 files: BC1's colour half and generated alpha."""
    dev, f = kinds.device, kinds.numel()
    colour = _bc1_words(kinds, n, gen)
    a0f = 200 + 20 * torch.randn(f, n, generator=gen, device=dev, dtype=torch.float64)
    a0 = _u8(a0f)
    a1 = (a0 - torch.randint(0, 64, (f, n), generator=gen, device=dev)).clamp(0, 255)
    idx_lo = torch.randint(0, 2 ** 16, (f, n), generator=gen, device=dev)
    idx_hi = torch.randint(0, 4, (f, n), generator=gen, device=dev) * 0x49249249
    return torch.cat([_bytes(a0, 1), _bytes(a1, 1), _bytes(idx_lo, 2),
                      _bytes(idx_hi, 4), colour], dim=-1)


_BLOCKS = {"bc1": _bc1_words, "bc3": _bc3_words}


@dataclass
class PoolFile:
    size: int
    blocks: int
    kind: str
    payload: bytes                # the texture payload (every mip level)
    extra: dict = field(default_factory=dict)


def make_pool(config: dict, seed: int, device: torch.device,
              keep_device: bool = False) -> List[PoolFile]:
    """The configuration's files in their seeded pool order. With ``keep_device``
    each file's payload also stays on ``device`` as ``extra["device"]``, a uint8
    view into its size class's tensor."""
    fmt = config["format"]
    rng = stream.rng(seed, stream.POOL)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kinds = [config["kinds"][k] for k in KINDS]
    files: List[PoolFile] = []
    for size, count in config["sizes"]:
        n = chain_blocks(size)
        counts = apportion(count, kinds)
        ids = rng.permutation(np.repeat(np.arange(len(KINDS)), counts))
        blocks = _BLOCKS[fmt](torch.as_tensor(ids, device=device), n, gen)
        blocks = blocks.to(torch.uint8).reshape(count, n * BLOCK_SIZE[fmt])
        host = blocks.cpu().numpy()
        for i in range(count):
            f = PoolFile(size, n, KINDS[int(ids[i])], host[i].tobytes())
            if keep_device:
                f.extra["device"] = blocks[i]
            files.append(f)
    order = rng.permutation(len(files))
    return [files[i] for i in order]
