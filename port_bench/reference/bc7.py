"""Plain PyTorch reference of the BC7 mode-sort transform and of the ``medium``
preset's BC7 search with its identity guard.

Written from the JAX package's numpy oracle (``oracle/bc7.py``, read as the
specification; nothing of it is imported) and its selection policy (``ops/bc7.py``
``ltu_identity_guard``):

- a block's mode is the number of trailing zero bits of its byte 0 (0-7); a byte 0 of
  0 is an invalid block, mode id 8;
- the mode stream packs the ids two a byte, the low nibble first, an odd tail padded
  with 0: ceil(n/2) bytes;
- the sort is stable by mode id *within each chunk* of :data:`SORT_CHUNK_BLOCKS`
  blocks (the ragged last chunk on its own), not over the whole payload;
- byte planes: the 16n bytes as 16 planes, plane j holding byte j of every block;
- the transformed payload is ``[mode stream][blocks]`` when sorting, the blocks
  alone otherwise, the blocks (sorted or not) as planes or as 16-byte blocks.

Search: each FAST candidate's whole transformed stream is scored by the exact LTU
estimate (:func:`.common.ltu_score`) at its own length, and the first candidate of
least score is the pick. Guard: where the pick is not the identity, its stream and
the payload are compressed by zstd level 1 (:func:`.zstd1.size`); the pick ships only
if its size is strictly smaller, and the identity ships otherwise.

No departures from the oracle: every length of whole blocks, mode ids 0-8 alike.
"""

from __future__ import annotations

import torch

from . import common, zstd1

BLOCK_SIZE = 16
SORT_CHUNK_BLOCKS = 4096
INVALID_MODE = 8
IDENTITY = {"sort_by_mode": False, "split_byte_planes": False}
# the FAST candidates in the CLI's order: identity first, the full layout last
FAST = tuple({"sort_by_mode": s, "split_byte_planes": p}
             for s, p in ((False, False), (True, False), (False, True), (True, True)))


def modes(payload: torch.Tensor) -> torch.Tensor:
    """(n,) int64 mode ids of the blocks of ``payload`` (uint8[16n])."""
    b0 = payload.view(-1, BLOCK_SIZE)[:, 0].to(torch.int64)
    out = torch.full_like(b0, INVALID_MODE)
    for bit in reversed(range(8)):  # the lowest set bit is written last
        out = torch.where((b0 >> bit) & 1 == 1, torch.full_like(b0, bit), out)
    return out


def mode_stream(ids: torch.Tensor) -> torch.Tensor:
    """The packed mode stream of ``ids``: ceil(n/2) uint8 bytes."""
    padded = torch.zeros(ids.numel() + ids.numel() % 2, dtype=torch.int64,
                         device=ids.device)
    padded[:ids.numel()] = ids
    return (padded[0::2] | (padded[1::2] << 4)).to(torch.uint8)


def sort_order(ids: torch.Tensor) -> torch.Tensor:
    """The chunk-local stable sort: ``order[p]`` is the block at sorted position p."""
    chunk = torch.arange(ids.numel(), device=ids.device) // SORT_CHUNK_BLOCKS
    return torch.sort(chunk * 16 + ids, stable=True).indices


def transform(payload: torch.Tensor, settings: dict) -> torch.Tensor:
    """The transformed payload of the BC7 blocks ``payload`` under ``settings``."""
    blocks = payload.view(-1, BLOCK_SIZE)
    prefix = payload[:0]
    if settings["sort_by_mode"]:
        ids = modes(payload)
        prefix = mode_stream(ids)
        blocks = blocks[sort_order(ids)]
    body = blocks.t() if settings["split_byte_planes"] else blocks
    return torch.cat([prefix, body.reshape(-1)])


def untransform(data: torch.Tensor, settings: dict) -> torch.Tensor:
    """Inverse of :func:`transform` (the reference's own round-trip tests)."""
    sort = settings["sort_by_mode"]
    n = data.numel() // BLOCK_SIZE
    if sort:  # 16n + ceil(n/2) bytes
        n = next(k for k in (2 * data.numel() // 33, 2 * data.numel() // 33 + 1)
                 if BLOCK_SIZE * k + (k + 1) // 2 == data.numel())
    head = (n + 1) // 2 if sort else 0
    body = data[head:head + BLOCK_SIZE * n]
    blocks = (body.view(BLOCK_SIZE, n).t() if settings["split_byte_planes"]
              else body.view(n, BLOCK_SIZE))
    if not sort:
        return blocks.reshape(-1).clone()
    packed = data[:head].to(torch.int64)
    ids = torch.stack([packed & 0xF, packed >> 4], dim=1).reshape(-1)[:n]
    out = torch.empty_like(blocks)
    out[sort_order(ids)] = blocks
    return out.reshape(-1)


def scores(payload: torch.Tensor, candidates=FAST) -> list:
    """The exact LTU score of each candidate's whole transformed stream."""
    rows = [transform(payload, c) for c in candidates]
    return [common.ltu_score(r, r.numel()) for r in rows]


def search(payload: torch.Tensor, candidates=FAST) -> tuple:
    """(index of the first candidate of least score, the scores)."""
    s = scores(payload, candidates)
    return s.index(min(s)), s


def guard(payload: torch.Tensor, pick: int, candidates=FAST) -> int:
    """The index that ships after the identity guard: ``pick`` where it is the
    identity or its stream compresses strictly smaller than the payload under zstd
    level 1, the identity's index otherwise."""
    ident = candidates.index(IDENTITY)
    if candidates[pick] == IDENTITY:
        return pick
    out = transform(payload, candidates[pick]).cpu().numpy()
    return pick if zstd1.size(out) < zstd1.size(payload.cpu().numpy()) else ident


def shipped(payload: torch.Tensor, candidates=FAST) -> tuple:
    """(the LTU pick, the index that ships) of the BC7 blocks ``payload``."""
    pick = search(payload, candidates)[0]
    return pick, guard(payload, pick, candidates)
