"""The BC7 corpus of a configuration, drawn from the seed on the device in a few large
calls per size class and kind, then copied to the host as the files a user would
hold (the BC7 counterpart of :mod:`.pool`, whose sizes, chains and file records it
shares).

Byte 0 of every block carries its mode as BC7 does: mode m is m zero bits and a one,
read from the low bit up; the bits above it are the start of the block's fields,
drawn at random (mode 7 has none). The modes are drawn from the configuration's
``modes`` mix, the real-encoder corpus's (``CORPUS_REPORT.md``). Each file is one of
five kinds, whose blocks are built so that the ``medium`` preset's search and guard
ship a known setting:

- ``identity``: each block is, with even odds, a fresh random block or a copy of the
  block before it. Whole blocks repeat 16 bytes back, which the identity layout alone
  keeps: the LTU search picks the identity.
- ``reverted``: a tile of 512 random blocks repeated over the file, each block
  replaced by a fresh random one with odds 1/8. The tile's period (8 KiB) lies beyond
  the LTU ladder in the block layout and on it (512) in the byte planes, so the
  search picks the planes; zstd-1 finds the period in the block layout too, where
  each replaced block breaks one match and not sixteen, so the guard ships the
  identity.
- ``sort``: the modes repeat a pattern of 64 blocks (a tiled texture's mode map),
  and the blocks of each mode come in runs of four equal blocks, in the order of that
  mode's blocks: sorting by mode puts each run together, 16 bytes apart, which byte
  planes do not repeat (a plane's four equal bytes are never a match), and zstd-1
  takes a sorted run as one match. The pattern makes the mode stream, which leads
  the sorted stream, periodic: zstd-1 steps over a long stretch of unmatched bytes
  ever faster, and after an unmatched mode stream it would miss the runs' matches
  for the rest of its first 128 KiB block.
- ``sort_planes``: each mode has one template for the file, which gives a block's
  bytes 0-11; bytes 12-15 are random. Sorted by mode, planes 0-11 are runs of one
  byte.
- ``planes``: bytes 1-11 are one template for the whole file, whatever the mode;
  byte 0 (the mode and random bits) and bytes 12-15 are random. Planes 1-11 are one
  byte throughout, sorted or not, so the mode stream is a cost with no gain.

How many files of each size and kind there are is fixed by the configuration (each
kind's files apportioned to its share, then dealt over the sizes, largest first, each
to the kind furthest below its share); where each file lies in the pool and every byte are drawn from the seed, so
every seed does the same work.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from port_bench import stream
from port_bench.pool import PoolFile, apportion, chain_blocks

BLOCK_SIZE = 16
KINDS = ("identity", "reverted", "sort", "sort_planes", "planes")
MODES = (1, 3, 4, 5, 6, 7)
TILE_BLOCKS = 512
REPLACE_ODDS = 1 / 8
SORT_RUN = 4
MODE_PERIOD = 64
TEMPLATE_BYTES = 12


def deal(sizes, shares) -> List[List[int]]:
    """For each size class ``(size, count)``, the count of each kind: each kind's
    files over all sizes apportioned to its share (``pool.apportion``), then dealt one
    by one, largest size first, each to the kind with files left whose count lies
    furthest below its share of the files dealt so far (ties to the earlier kind)."""
    total = sum(float(s) for s in shares)
    weights = [float(s) / total for s in shares]
    left = apportion(sum(count for _, count in sizes), shares)
    got = [0] * len(weights)
    dealt = 0
    out = []
    for _, count in sorted(sizes, key=lambda sc: -sc[0]):
        row = [0] * len(weights)
        for _ in range(count):
            dealt += 1
            k = max((j for j in range(len(weights)) if left[j]),
                    key=lambda j: (weights[j] * dealt - got[j], -j))
            got[k] += 1
            left[k] -= 1
            row[k] += 1
        out.append(row)
    return out


def _modes(f: int, n: int, mix, gen, dev) -> torch.Tensor:
    """(f, n) int64 mode ids drawn from ``mix`` (shares of :data:`MODES`)."""
    cum = torch.tensor(np.cumsum(mix) / np.sum(mix), dtype=torch.float64, device=dev)
    pick = torch.bucketize(torch.rand(f, n, generator=gen, device=dev,
                                      dtype=torch.float64), cum[:-1], right=True)
    return torch.tensor(MODES, device=dev)[pick]


def _byte0(ids: torch.Tensor, gen) -> torch.Tensor:
    """Byte 0 of blocks of mode ``ids``: the mode's bit, zeros below, random above."""
    high = torch.randint(0, 256, ids.shape, generator=gen, device=ids.device)
    return ((1 << ids) | ((high << (ids + 1)) & 0xFF)) & 0xFF


def _random_blocks(ids: torch.Tensor, gen) -> torch.Tensor:
    """(f, n, 16) random blocks of the modes ``ids``."""
    b = torch.randint(0, 256, (*ids.shape, BLOCK_SIZE), generator=gen, device=ids.device)
    b[..., 0] = _byte0(ids, gen)
    return b


def _take(blocks: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``blocks[f, src[f, i]]`` for every (f, i)."""
    return blocks.gather(1, src[..., None].expand(-1, -1, BLOCK_SIZE))


def _identity(ids, gen):
    f, n = ids.shape
    dev = ids.device
    fresh = torch.rand(f, n, generator=gen, device=dev) < 0.5
    fresh[:, 0] = True
    pos = torch.arange(n, device=dev).expand(f, n)
    src = torch.where(fresh, pos, torch.zeros_like(pos)).cummax(dim=1).values
    return _take(_random_blocks(ids, gen), src)


def _reverted(ids, gen):
    f, n = ids.shape
    dev = ids.device
    tile = _random_blocks(ids[:, :TILE_BLOCKS], gen)
    reps = -(-n // tile.shape[1])
    out = tile.repeat(1, reps, 1)[:, :n]
    fresh = _random_blocks(ids, gen)
    replace = torch.rand(f, n, generator=gen, device=dev) < REPLACE_ODDS
    return torch.where(replace[..., None], fresh, out)


def _sort(ids, gen):
    """Runs of :data:`SORT_RUN` equal blocks in each mode's order, over modes that
    repeat the file's first :data:`MODE_PERIOD` blocks' modes."""
    f, n = ids.shape
    ids = ids[:, :MODE_PERIOD].repeat(1, -(-n // MODE_PERIOD))[:, :n]
    order = torch.sort(ids, dim=1, stable=True).indices   # sorted position -> block
    sorted_ids = ids.gather(1, order)
    pos = torch.arange(n, device=ids.device).expand(f, n)
    start = torch.where(torch.cat([torch.ones_like(sorted_ids[:, :1], dtype=torch.bool),
                                   sorted_ids[:, 1:] != sorted_ids[:, :-1]], dim=1),
                        pos, torch.zeros_like(pos)).cummax(dim=1).values
    rank = pos - start
    lead = order.gather(1, start + rank - rank % SORT_RUN)   # sorted position -> leader
    src = torch.empty_like(order).scatter_(1, order, lead)
    return _take(_random_blocks(ids, gen), src)


def _sort_planes(ids, gen):
    f, n = ids.shape
    dev = ids.device
    templates = torch.randint(0, 256, (f, 8, BLOCK_SIZE), generator=gen, device=dev)
    templates[..., 0] = _byte0(torch.arange(8, device=dev).expand(f, 8), gen)
    out = _take(templates, ids)
    rnd = torch.randint(0, 256, (f, n, BLOCK_SIZE - TEMPLATE_BYTES), generator=gen,
                        device=dev)
    return torch.cat([out[..., :TEMPLATE_BYTES], rnd], dim=2)


def _planes(ids, gen):
    f, n = ids.shape
    out = _random_blocks(ids, gen)
    template = torch.randint(0, 256, (f, 1, TEMPLATE_BYTES - 1), generator=gen,
                             device=ids.device)
    out[..., 1:TEMPLATE_BYTES] = template
    return out


_KIND = {"identity": _identity, "reverted": _reverted, "sort": _sort,
         "sort_planes": _sort_planes, "planes": _planes}


def make_pool(config: dict, seed: int, device: torch.device,
              keep_device: bool = False) -> List[PoolFile]:
    """The configuration's files in their seeded pool order. With ``keep_device``
    each file's payload also stays on ``device`` as ``extra["device"]``."""
    rng = stream.rng(seed, stream.POOL)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shares = [config["kinds"][k] for k in KINDS]
    mix = [config["modes"][str(m)] for m in MODES]
    sizes = sorted(config["sizes"], key=lambda sc: -sc[0])
    files: List[PoolFile] = []
    for (size, count), counts in zip(sizes, deal(sizes, shares)):
        n = chain_blocks(size)
        for name, c in zip(KINDS, counts):
            if not c:
                continue
            ids = _modes(c, n, mix, gen, device)
            blocks = _KIND[name](ids, gen).to(torch.uint8).reshape(c, -1)
            host = blocks.cpu().numpy()
            for j in range(c):
                pf = PoolFile(size, n, name, host[j].tobytes())
                if keep_device:
                    pf.extra["device"] = blocks[j]
                files.append(pf)
    order = rng.permutation(len(files))
    return [files[i] for i in order]
