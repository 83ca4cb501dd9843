"""Batched auto-search steps of the corpus pipeline (BC1-BC5), on one device or
sharded over a mesh.

Counterpart of ``dxt_lossless_transform_tpu/parallel/sharded.py``: ``auto_step_batched``
(:855) and the host-scored regions step (:833), ``_bc{1..5}_batched_impl`` (:542-687)
and their host-scored twins (:725-830), ``_colour_rows_batched`` (:500),
``bc{1..5}_auto_step_single`` (:262-415, :689-714), and under a mesh
``bc{1..5}_auto_step`` (:871-913), ``_scores_flat_shardmap`` (:427-473),
``_mesh_words_call`` (:190-227), ``modesort_transform_step`` (:931) and
``untransform_step`` (:949). A batch is a (B, W) int32 tensor of B files' block
words, each file padded with zeros to the batch's bucket of ``W / words per block``
blocks, and a (B,) list of valid lengths, ``4 n_b`` for a file of ``n_b`` blocks (its
colour region's bytes), as in the JAX package.

:class:`BatchStep` is the one BC1-BC5 batch step, whatever scores it: it picks what
the JAX step with the same estimator picks (JAX's device-scored step under LTU, its
host-scored step under a host estimator such as zstd-1), and returns, as tensors on
the batch's device (under a mesh, on ``mesh.home``), ``(rows, best)``: the winning
candidate of each file (``best``) and the (B, block_size·bucket) uint8 rows whose row
b begins with file b's transformed bytes under that candidate, the bytes JAX's
pipeline serializes. On one device it runs:

1. the format's region kernel (``dlt_bc{1,2,3}_regions``) on the whole flat batch
   (BC4/BC5: ``deinterleave_words``, ``dlt_deinterleave_words``, and the endpoint
   rows in plain torch);
2. each file's rows cut out at its own valid length, in plain torch;
3. one call of the estimator's ``estimate_parts_device`` over every row of the batch,
   each at its own valid length (LTU: one ``dlt_ltu_counts_rows``; a host estimator:
   one copy of the rows to the host and one ``estimate_batch``);
4. the argmin per file, ties to the first candidate;
5. the format's rows kernel (``dlt_bc{1..5}_transform_rows``,
   :func:`..ops.cuda.shuffle.transform_rows`) over the candidates' distinct keys:
   each file's bytes under its winner.

Steps 1-2 are :meth:`BatchStep.regions` and 3-5 :meth:`BatchStep.finish`, so that a
caller can score a host estimator's rows while the device runs the next batch.

The region kernel writes a split row of the flat batch as ``[c0 of all B·bucket
blocks | c1 of all]``: file b's c0 is at ``2·b·bucket … 2·(b·bucket + n_b)`` and its
c1 the same range ``2·B·bucket`` further on, so file b's row is ``c0[:2 n_b] ‖
c1[:2 n_b]``, not the bucket-padded pair (:func:`_put_split`); BC3's split alpha row
is the same with 1-byte lanes. BC4 and BC5 have no region kernel: their endpoint
rows come from the deinterleaved lanes (``sharded.py:640-687``). The tail of a row
past its valid length is never read. BC3 scores its alpha rows (``2 n_b`` valid)
and its colour rows (``4 n_b``) in the one call. BC5 scores its red and green
endpoint rows apart and sums them under an estimator that scores on the device, as
the JAX batch step does, and joined (red ‖ green, ``4 n_b``) under a host estimator,
as the per-file search and JAX's host-scored batch do.

Under a mesh (:mod:`.mesh`) the same steps run per shard. LTU counts each shard's
chunk of the rows with its halos (``dlt_ltu_counts_windowed``); see the section
below. Any other estimator scores the whole rows gathered on ``mesh.home``. JAX's
gates that send other shapes to a GSPMD XLA path have no counterpart: the kernels
take any shape, so a mesh step always runs the windowed kernel, also on chunks
shorter than its halo and buckets that the blocks axis does not divide.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..estimate.cuda_ltu import SPAN, device_lengths, ltu_counts_windowed
from ..estimate.gtable import ENTROPY_CAP
from ..estimate.ltu import (
    DEFAULT_OFFSETS, WEIGHT_SCALE, LtuEstimation, entropy_from_histograms,
    offset_weight, prefix_histograms, prefix_lengths,
)
from ..ops import lanes
from ..ops.auto import distinct
from ..ops.cuda import regions as cuda_regions
from ..ops.cuda.planes import deinterleave_words
from ..ops.cuda.shuffle import transform_rows
from ..settings import (
    BC1_FAST_CANDIDATES, BC2_FAST_CANDIDATES, BC3_FAST_CANDIDATES,
    Bc4TransformSettings, Bc5TransformSettings,
)
from . import mesh as mesh_lib

_BC1_CANDIDATES: Tuple[Tuple[int, bool], ...] = tuple(
    (int(c.decorrelation_mode), c.split_colour_endpoints) for c in BC1_FAST_CANDIDATES)
_BC2_CANDIDATES: Tuple[Tuple[int, bool], ...] = tuple(
    (int(c.decorrelation_mode), c.split_colour_endpoints) for c in BC2_FAST_CANDIDATES)
_BC3_CANDIDATES: Tuple[Tuple[int, bool, bool], ...] = tuple(
    (int(c.decorrelation_mode), c.split_alpha_endpoints, c.split_colour_endpoints)
    for c in BC3_FAST_CANDIDATES)
_BC4_CANDIDATES: Tuple[Tuple[bool], ...] = tuple(
    (c.split_endpoints,) for c in Bc4TransformSettings.all_combinations())
_BC5_CANDIDATES: Tuple[Tuple[bool], ...] = tuple(
    (c.split_endpoints,) for c in Bc5TransformSettings.all_combinations())

# words per block
_WORDS = {"bc1": 2, "bc2": 4, "bc3": 4, "bc4": 2, "bc5": 4}


def _blocks(valid_lens) -> list:
    """Each file's block count from its valid length (4 bytes per block)."""
    return [int(v) // 4 for v in (valid_lens.tolist()
                                 if isinstance(valid_lens, torch.Tensor) else valid_lens)]


def _words(flats: torch.Tensor, k: int) -> tuple:
    """(B, W) batch -> k lanes, each (B, W/k), by one deinterleave over the batch."""
    B = flats.shape[0]
    return tuple(s.view(B, -1) for s in deinterleave_words(flats.reshape(-1), k))


def _put_split(dst: torch.Tensor, halves: torch.Tensor, ns: Sequence[int]) -> None:
    """Write each file's split row into ``dst`` (B, 2P): ``halves`` (2, B, P) holds
    every file's low and high lane stream, file b's row is the first ``ns[b]``
    bytes of its low stream then the first ``ns[b]`` of its high one."""
    dst[:, :halves.shape[2]] = halves[0]
    for b, n in enumerate(ns):
        dst[b, n:2 * n] = halves[1, b, :n]


def _colour_rows_batched(flats, ns, keys, wpb: int, region_fn) -> torch.Tensor:
    """BC1/BC2 batch rows: the (B, K, 4·bucket) colour rows of the K distinct
    candidate keys ``keys``."""
    B, W = flats.shape
    bucket = W // wpb
    region = region_fn(flats.view(torch.uint8).reshape(-1), keys)
    rows = torch.empty((B, len(keys), 4 * bucket), dtype=torch.uint8,
                       device=flats.device)
    for c, (_, split) in enumerate(keys):
        if split:
            _put_split(rows[:, c], region[c].view(2, B, 2 * bucket), [2 * n for n in ns])
        else:
            rows[:, c] = region[c].view(B, 4 * bucket)
    return rows


def _bc3_keys(candidates) -> tuple:
    alpha_keys, ai = distinct([sa for _, sa, _ in candidates])
    colour_keys, ci = distinct([(v, sc) for v, _, sc in candidates])
    return alpha_keys, colour_keys, ai, ci


def _bc3_rows(flats, ns, alpha_keys, colour_keys):
    """(B, A+K, 4·bucket) rows: the A distinct alpha-endpoint rows (2·n_b bytes
    valid) then the K distinct colour rows (4·n_b)."""
    B, W4 = flats.shape
    bucket = W4 // 4
    alpha, colour = cuda_regions.bc3_regions(flats.view(torch.uint8).reshape(-1),
                                             alpha_keys, colour_keys)
    A = len(alpha_keys)
    rows = torch.empty((B, A + len(colour_keys), 4 * bucket), dtype=torch.uint8,
                       device=flats.device)
    for a, split in enumerate(alpha_keys):
        if split:
            _put_split(rows[:, a, :2 * bucket], alpha[a].view(2, B, bucket), ns)
        else:
            rows[:, a, :2 * bucket] = alpha[a].view(B, 2 * bucket)
    for c, (_, split) in enumerate(colour_keys):
        if split:
            _put_split(rows[:, A + c], colour[c].view(2, B, 2 * bucket),
                       [2 * n for n in ns])
        else:
            rows[:, A + c] = colour[c].view(B, 4 * bucket)
    return rows


def _ep_rows(ep: torch.Tensor, ns, keys) -> torch.Tensor:
    """BC4/BC5 endpoint rows (B, K, 2·bucket) of the distinct ``split_endpoints``
    keys from the u16 endpoint lane ``ep`` (B, bucket): split, the a0 bytes then the
    a1 bytes of the file's n_b blocks; else the u16 values as they lie."""
    B, bucket = ep.shape
    rows = torch.empty((B, len(keys), 2 * bucket), dtype=torch.uint8, device=ep.device)
    for c, split in enumerate(keys):
        if split:
            halves = torch.stack([ep & 0xFF, ep >> 8]).to(torch.uint8)
            _put_split(rows[:, c], halves, ns)
        else:
            rows[:, c] = ep.to(torch.int16).view(torch.uint8)
    return rows


def _bc5_parts(red: torch.Tensor, green: torch.Tensor, ns, joined: bool) -> list:
    """BC5's (B, K, 2P) red and green endpoint rows -> the rows to score: joined, one
    (B, K, 4P) row a key, the file's red row's 2·n_b bytes then its green row's; else
    the red rows then the green ones."""
    K = red.shape[1]
    if not joined:
        return [(torch.cat([red, green], dim=1), [2] * 2 * K)]
    rows = torch.empty((red.shape[0], K, 2 * red.shape[2]), dtype=torch.uint8,
                       device=red.device)
    for c in range(K):
        _put_split(rows[:, c], torch.stack([red[:, c], green[:, c]]), [2 * n for n in ns])
    return [(rows, [4] * K)]


def _rows(fmt: str, flats, ns, keys, joined: bool) -> list:
    """The batch's rows on its device: [(rows (B, X, L), each row's bytes a block)]."""
    if fmt in ("bc1", "bc2"):
        rows = _colour_rows_batched(flats, ns, keys[0], _WORDS[fmt],
                                    getattr(cuda_regions, f"{fmt}_regions"))
        return [(rows, [4] * len(keys[0]))]
    if fmt == "bc3":
        return [(_bc3_rows(flats, ns, *keys), [2] * len(keys[0]) + [4] * len(keys[1]))]
    if fmt == "bc4":
        ep, _ = lanes.split_u32(_words(flats, 2)[0])
        return [(_ep_rows(ep, ns, keys[0]), [2] * len(keys[0]))]
    rw0, _, gw0, _ = _words(flats, 4)
    red, green = (_ep_rows(lanes.split_u32(w)[0], ns, keys[0]) for w in (rw0, gw0))
    return _bc5_parts(red, green, ns, joined)


def _score(estimator, parts, ns) -> torch.Tensor:
    """(B, R) scores of the parts' rows, each at its file's length, in one
    ``estimate_parts_device`` call; the parts' rows side by side."""
    scores = [s.view(len(ns), -1) for s in estimator.estimate_parts_device([
        (rows.reshape(-1, rows.shape[2]),
         torch.tensor([u * n for n in ns for u in per_block], dtype=torch.int64))
        for rows, per_block in parts])]
    return scores[0] if len(scores) == 1 else torch.cat(scores, dim=1)


class BatchStep:
    """The BC1-BC5 batch step of ``fmt``: ``step(flats, valid_lens) -> (rows, best)``
    over ``candidates`` (the settings' keys: (variant, split) for BC1/BC2, (variant,
    split_alpha, split_colour) for BC3, (split,) for BC4/BC5), scored by
    ``estimator``; with a ``mesh``, sharded over it (the batch's file count a multiple
    of its files axis). The estimator decides the two choices the JAX package makes
    by step: BC5's rows scored apart under one that scores on the device, joined
    under a host one; and under a mesh, the windowed scorer for LTU, the gathered
    rows for any other."""

    def __init__(self, fmt: str, candidates, estimator, mesh=None):
        self.fmt, self.candidates, self.estimator = fmt, tuple(candidates), estimator
        self.mesh = None if mesh is None else mesh_lib.require(mesh)
        self.joined = fmt == "bc5" and not estimator.scores_on_device
        # the rows' keys, and each candidate's rows whose scores add up to its own
        if fmt == "bc3":
            alpha_keys, colour_keys, ai, ci = _bc3_keys(self.candidates)
            self.keys = (alpha_keys, colour_keys)
            self.terms = [ai, [len(alpha_keys) + c for c in ci]]
        else:
            keys, index = distinct(self.candidates if fmt in ("bc1", "bc2")
                                   else [split for split, in self.candidates])
            self.keys = (keys,)
            self.terms = ([index, [len(keys) + k for k in index]]
                          if fmt == "bc5" and not self.joined else [index])
        # the rows kernel takes the distinct candidates; a pick maps to its key
        self.distinct, index = distinct(self.candidates)
        self._key_of = None if index == list(range(len(index))) else index

    def regions(self, flats: torch.Tensor, valid_lens) -> tuple:
        """The rows of the batch on its device -> (each file's block count, a call
        that scores them: (B, R) scores)."""
        ns = _blocks(valid_lens)
        if self.mesh is None:
            parts = _rows(self.fmt, flats, ns, self.keys, self.joined)
            return ns, lambda: _score(self.estimator, parts, ns)
        sh = _Shards(self.mesh, flats, ns, _WORDS[self.fmt])
        groups = _mesh_local(sh, _LOCALS[self.fmt], self.keys)
        if isinstance(self.estimator, LtuEstimation):
            scores = torch.cat([sh.scores(group, self.estimator.offsets)
                                for group in groups], dim=1)
            return ns, lambda: scores
        parts = [sh.rows(group) for group in groups]
        if self.fmt == "bc5":
            K = len(self.keys[0])
            parts = _bc5_parts(parts[0][0][:, :K], parts[0][0][:, K:], ns, self.joined)
        return ns, lambda: _score(self.estimator, parts, ns)

    def finish(self, flats: torch.Tensor, regions: tuple) -> tuple:
        """Score the rows of :meth:`regions`, pick each file's first least candidate
        (``best``), and transform the batch's files under theirs by the format's rows
        kernel -> (rows, best)."""
        ns, score = regions
        scores = score()
        total = scores[:, self.terms[0]]
        for term in self.terms[1:]:
            total = total + scores[:, term]
        best = torch.argmin(total, dim=1)
        key = best if self._key_of is None else torch.tensor(
            self._key_of, device=best.device)[best]
        if self.mesh is not None:
            flats = flats.to(self.mesh.home)
        return transform_rows(self.fmt, flats, ns, key, self.distinct), best

    def __call__(self, flats: torch.Tensor, valid_lens) -> tuple:
        return self.finish(flats, self.regions(flats, valid_lens))


def _single(fmt, flat, valid_len, candidates, offsets):
    wpb = _WORDS[fmt]
    n = flat.shape[0] // wpb if valid_len is None else int(valid_len) // 4
    rows, best = BatchStep(fmt, candidates, LtuEstimation(offsets))(flat.view(1, -1),
                                                                    [4 * n])
    return rows[0, :4 * wpb * n], best[0]


def bc1_auto_step_single(flat, valid_len=None, candidates=_BC1_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[2N] word image -> (the transformed bytes of the first valid_len / 4
    blocks, all by default, under the winner: uint8[8n], best)."""
    return _single("bc1", flat, valid_len, candidates, offsets)


def bc2_auto_step_single(flat, valid_len=None, candidates=_BC2_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (transformed bytes uint8[16n], best)."""
    return _single("bc2", flat, valid_len, candidates, offsets)


def bc3_auto_step_single(flat, valid_len=None, candidates=_BC3_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (transformed bytes uint8[16n], best)."""
    return _single("bc3", flat, valid_len, candidates, offsets)


def bc4_auto_step_single(flat, valid_len=None, candidates=_BC4_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[2N] word image -> (transformed bytes uint8[8n], best)."""
    return _single("bc4", flat, valid_len, candidates, offsets)


def bc5_auto_step_single(flat, valid_len=None, candidates=_BC5_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (transformed bytes uint8[16n], best)."""
    return _single("bc5", flat, valid_len, candidates, offsets)


def auto_step_batched(fmt: str, candidates, offsets=DEFAULT_OFFSETS) -> BatchStep:
    """The LTU batch step ``step(flats, valid_lens)`` of ``fmt`` (full and ragged
    batches alike: the JAX step's ``full`` shortcut has no counterpart)."""
    return BatchStep(fmt, candidates, LtuEstimation(offsets))


def modesort_step_single(flat: torch.Tensor, valid_len=None, fmt: str = "bc7") -> tuple:
    """BC7/BC6H blocks (uint8[16N], or int32[4N] words) -> ((16, n) byte planes, the
    packed mode stream) of the first ``valid_len`` blocks (all by default): the
    sort+planes layout, by one transform launch (JAX ``sharded.py:918``)."""
    from ..ops.cuda import planes

    x = flat.view(torch.uint8).reshape(-1)
    n = x.numel() // 16 if valid_len is None else int(valid_len)
    out = planes.bc7_transform(x[:16 * n], planes.BC7 if fmt == "bc7" else planes.BC6H,
                               True, True)
    msl = planes.mode_stream_len(n)
    return out[msl:].view(16, n), out[:msl]


# --- under a mesh ---------------------------------------------------------------------
# Position (f, s) of a (files, blocks) mesh holds the words of files f·Bl .. (f+1)·Bl
# (Bl = B / files) and blocks s·bc .. (s+1)·bc of each (bc = the bucket / blocks; a
# bucket that the blocks axis does not divide is padded with zero blocks, which no
# valid length reaches). The transform is per block, so each shard runs the
# deinterleave and the format's region kernel on its own words (JAX
# ``_mesh_words_call``, :190-227). A scored row is the concatenation of lane parts:
# one part of u bytes a block, or a split candidate's low then high lanes, the high
# ones at byte u·n_b of the file's row (:func:`_put_split`). The scorer cuts each
# file's rows into the blocks axis's chunks: the first part of every row moves for
# all files at once, the later parts file by file, since they start at the file's
# own n_b; then each chunk gets its halos, SPAN bytes of its neighbours (all of them
# where a chunk is shorter than SPAN; zeros before the row's start). Each position
# launches ``dlt_ltu_counts_windowed`` once over all its rows of a width, and the
# partial counts and the partial byte histograms of the rows' first ENTROPY_CAP bytes
# are summed over the positions onto ``mesh.home`` (one ``all_reduce`` across ranks):
# JAX's halo ``ppermute`` and ``psum`` (:427-473). For any other estimator the rows
# are gathered onto ``mesh.home`` whole (:meth:`_Shards.rows`) and scored there. Every
# output is on ``mesh.home``, whole, as ``jax.device_get`` of the global arrays gives it.

def _pieces(lo: int, hi: int, width: int):
    """[lo, hi) cut at the multiples of ``width``."""
    while lo < hi:
        end = min(hi, (lo // width + 1) * width)
        yield lo, end
        lo = end


def _move(src, src_of, src_index, dst, dst_of, dst_index):
    return (src, lambda: src_of(src)[src_index], dst, lambda: dst_of(dst)[dst_index])


def _split_rows(region: torch.Tensor, splits, bl: int, u: int) -> tuple:
    """A region kernel's (K, Bl·u·bc) output -> (row blocks, key of each row): key c's
    row of a file is its u bytes a block, or when split (``splits[c]``) its low then
    its high u/2-byte lanes, each laid over all Bl files in turn. A row block is a
    list of lane parts, each (Bl, X, lane·bc) bytes with its lane width."""
    region = region.view(len(splits), -1)
    plain = [c for c, split in enumerate(splits) if not split]
    halved = [c for c, split in enumerate(splits) if split]
    blocks = []
    if plain:
        blocks.append([(region[plain].view(len(plain), bl, -1).transpose(0, 1), u)])
    if halved:
        halves = region[halved].view(len(halved), 2, bl, -1)
        blocks.append([(halves[:, 0].transpose(0, 1), u // 2),
                       (halves[:, 1].transpose(0, 1), u // 2)])
    return blocks, plain + halved


def _ep_region(ep: torch.Tensor, keys) -> torch.Tensor:
    """BC4/BC5 endpoint region (K, Bl·2·bc) of the u16 endpoint lane ``ep`` (Bl, bc):
    a split key's a0 bytes of all Bl files then their a1 bytes, else the u16 values
    as they lie (:func:`_ep_rows` on one shard)."""
    out = torch.empty((len(keys), 2 * ep.numel()), dtype=torch.uint8, device=ep.device)
    for c, split in enumerate(keys):
        if split:
            out[c] = torch.stack([ep & 0xFF, ep >> 8]).to(torch.uint8).reshape(-1)
        else:
            out[c] = ep.to(torch.int16).view(torch.uint8).reshape(-1)
    return out


class _Shards:
    """A (B, W) batch's words cut over a mesh, and the moves of its rows."""

    def __init__(self, mesh, flats: torch.Tensor, ns: Sequence[int], wpb: int):
        self.mesh = mesh_lib.require(mesh)
        self.nf, self.nb = mesh.shape["files"], mesh.shape["blocks"]
        B, W = flats.shape
        if B % self.nf:
            raise ValueError(f"a batch of {B} files does not divide over the files "
                             f"axis of {self.nf}")
        self.bl, self.n_blocks = B // self.nf, W // wpb
        self.bc = -(-self.n_blocks // self.nb)
        if self.nb * self.bc > self.n_blocks:
            flats = torch.cat([flats, flats.new_zeros(
                (B, wpb * (self.nb * self.bc - self.n_blocks)))], dim=1)
        self.ns = list(ns)  # each file's block count
        w = wpb * self.bc
        self.words = {(f, s): flats[f * self.bl:(f + 1) * self.bl, s * w:(s + 1) * w]
                      .contiguous().to(mesh.devices[f, s]) for f, s in mesh.positions}

    def gather(self, shards: dict) -> torch.Tensor:
        """(Bl, bc) lanes of every position -> the (B, blocks) lanes on home."""
        return self.mesh.gather(shards, 1)[:, :self.n_blocks]

    def chunk_moves(self, blocks: dict, target) -> tuple:
        """The moves that write chunk s of every file's rows, the concatenation of
        the lane parts of ``blocks`` (per position, a list of row blocks), into
        ``target(pos)`` (Bl, X, U·bc): (the first parts' moves, the later parts')."""
        bc, nb, bl = self.bc, self.nb, self.bl
        some = blocks[self.mesh.positions[0]]
        width = sum(u for _, u in some[0]) * bc
        first, later = [], []
        r0 = 0
        for j, parts in enumerate(some):
            rows = slice(r0, r0 + parts[0][0].shape[1])
            r0 = rows.stop
            for i, (_, u) in enumerate(parts):
                part_of = (lambda pos, j=j, i=i: blocks[pos][j][i][0])
                if i == 0:
                    # every file's bytes [0, u·nb·bc) of the row, at once
                    for f in range(self.nf):
                        for s_src in range(nb):
                            base = s_src * u * bc
                            for lo, hi in _pieces(base, base + u * bc, width):
                                s_dst = lo // width
                                first.append(_move(
                                    (f, s_src), part_of,
                                    (slice(None), slice(None), slice(lo - base, hi - base)),
                                    (f, s_dst), target,
                                    (slice(None), rows,
                                     slice(lo - s_dst * width, hi - s_dst * width))))
                    continue
                for b, n in enumerate(self.ns):
                    f, lb = divmod(b, bl)
                    start = sum(p[1] for p in parts[:i]) * n  # the part's start in the row
                    for s_src in range(nb):
                        base, end = s_src * u * bc, min((s_src + 1) * u * bc, u * n)
                        if base >= end:
                            break
                        for lo, hi in _pieces(start + base, start + end, width):
                            s_dst = lo // width
                            later.append(_move(
                                (f, s_src), part_of,
                                (lb, slice(None), slice(lo - start - base, hi - start - base)),
                                (f, s_dst), target,
                                (lb, rows, slice(lo - s_dst * width, hi - s_dst * width))))
        return first, later

    def halo_moves(self, windows, width: int) -> list:
        """The moves that fill each window's SPAN-byte halos from the chunks (the
        window's middles) of the other positions of its files-row."""
        moves, total = [], self.nb * width
        for f in range(self.nf):
            for s in range(self.nb):
                start, end = s * width, (s + 1) * width
                for lo, hi, at in ((max(0, start - SPAN), start, SPAN - start),
                                   (end, min(end + SPAN, total), SPAN + width - end)):
                    for a, b in _pieces(lo, hi, width):
                        s_src = a // width
                        moves.append(_move(
                            (f, s_src), windows,
                            (Ellipsis, slice(SPAN + a - s_src * width, SPAN + b - s_src * width)),
                            (f, s), windows, (Ellipsis, slice(at + a, at + b))))
        return moves

    def rows(self, group) -> tuple:
        """A row group's whole rows on home, by label, for an estimator that scores
        whole rows: ((B, labels, U·blocks) rows, each row's bytes a block)."""
        blocks, labels = group
        mesh, some = self.mesh, next(iter(blocks.values()))
        per_block = sum(u for _, u in some[0])
        chunks = {pos: torch.zeros((self.bl, len(labels), per_block * self.bc),
                                   dtype=torch.uint8, device=mesh.devices[pos])
                  for pos in mesh.positions}
        for moves in self.chunk_moves(blocks, chunks.__getitem__):
            mesh.run(moves)
        rows = mesh.gather(chunks, 2)[:, :, :per_block * self.n_blocks]
        return (rows[:, [labels.index(c) for c in range(len(labels))]],
                [per_block] * len(labels))

    def scores(self, group, offsets) -> torch.Tensor:
        """A row group's (B, labels) exact scores on home, by label: each position's
        windows through ``dlt_ltu_counts_windowed``, the partial counts and prefix
        histograms summed over the mesh."""
        blocks, labels = group
        mesh, some = self.mesh, next(iter(blocks.values()))
        per_block = sum(u for _, u in some[0])
        width, x = per_block * self.bc, len(labels)
        windows = {pos: torch.zeros((self.bl, x, SPAN + width + SPAN), dtype=torch.uint8,
                                    device=mesh.devices[pos]) for pos in mesh.positions}
        first, later = self.chunk_moves(
            blocks, lambda pos: windows[pos][:, :, SPAN:SPAN + width])
        mesh.run(first)
        mesh.run(later)
        mesh.run(self.halo_moves(windows.__getitem__, width))
        # the step's lengths, each file's once per label as the rows lie, reach each
        # device once; every shard's count and histogram reads its files' rows of them
        # there, with the longest from the host
        valid = torch.tensor([per_block * n for n in self.ns],
                             dtype=torch.int64).repeat_interleave(x)
        lengths = {dev: device_lengths(valid, dev)
                   for dev in {*(w.device for w in windows.values()), mesh.home}}
        ks = sorted(set(int(k) for k in offsets))
        ws = [offset_weight(k) for k in ks]
        parts = {}
        for (f, s), win in windows.items():
            rows = win.view(self.bl * x, -1)
            v = lengths[rows.device].slice(f * self.bl * x, (f + 1) * self.bl * x)
            counts = ltu_counts_windowed(rows, v, s * width - SPAN, ks, ws)
            hist = prefix_histograms(rows[:, SPAN:SPAN + width],
                                     prefix_lengths(v.lengths, rows.device), ENTROPY_CAP,
                                     start=s * width)
            parts[f, s] = torch.cat([counts[:, None], hist], dim=1)
        total = mesh.sum_files(parts).view(-1, 257)
        v = lengths[mesh.home].lengths
        scores = (WEIGHT_SCALE * v - total[:, 0]
                  + entropy_from_histograms(total[:, 1:], prefix_lengths(v, mesh.home)))
        return scores.view(-1, x)[:, [labels.index(c) for c in range(x)]]


def _splits(keys) -> list:
    return [split for _, split in keys]


def _colour_local(fmt: str):
    """BC1/BC2 shard: [the colour rows of the distinct keys]."""
    def local(x, bl, keys):
        region = getattr(cuda_regions, f"{fmt}_regions")(x.view(torch.uint8).reshape(-1),
                                                         keys[0])
        return [_split_rows(region, _splits(keys[0]), bl, 4)]
    return local


def _bc3_local(x, bl, keys):
    alpha_keys, colour_keys = keys
    alpha, colour = cuda_regions.bc3_regions(x.view(torch.uint8).reshape(-1), alpha_keys,
                                             colour_keys)
    return [_split_rows(alpha, alpha_keys, bl, 2),
            _split_rows(colour, _splits(colour_keys), bl, 4)]


def _bc4_local(x, bl, keys):
    ep, _ = lanes.split_u32(_words(x, 2)[0])
    return [_split_rows(_ep_region(ep, keys[0]), keys[0], bl, 2)]


def _bc5_local(x, bl, keys):
    """The red then the green endpoint rows, in one group: labels K.. are green."""
    rw0, _, gw0, _ = _words(x, 4)
    red, red_order = _split_rows(_ep_region(lanes.split_u32(rw0)[0], keys[0]), keys[0],
                                 bl, 2)
    green, green_order = _split_rows(_ep_region(lanes.split_u32(gw0)[0], keys[0]),
                                     keys[0], bl, 2)
    k = len(keys[0])
    return [(red + green, red_order + [k + c for c in green_order])]


# per format: a shard's row groups, in the order of the one-device rows
_LOCALS = {"bc1": _colour_local("bc1"), "bc2": _colour_local("bc2"), "bc3": _bc3_local,
           "bc4": _bc4_local, "bc5": _bc5_local}


def _mesh_local(sh: _Shards, local, keys) -> list:
    """The row groups of every position: [(row blocks by position, labels)]."""
    out = {pos: local(x, sh.bl, keys) for pos, x in sh.words.items()}
    some = next(iter(out.values()))
    return [({pos: o[g][0] for pos, o in out.items()}, labels)
            for g, (_, labels) in enumerate(some)]


def auto_step(fmt: str, mesh, candidates, offsets=DEFAULT_OFFSETS) -> BatchStep:
    """The LTU batch step ``step(flats, valid_lens)`` of ``fmt`` under a mesh: what
    :func:`auto_step_batched` returns, as tensors on ``mesh.home``. The scores come
    from the shards; the format's rows kernel then transforms the batch on
    ``mesh.home`` (each rank holds the whole batch). The batch's file count must be
    a multiple of the files axis."""
    return BatchStep(fmt, candidates, LtuEstimation(offsets), mesh)


def bc1_auto_step(mesh, candidates=_BC1_CANDIDATES, offsets=DEFAULT_OFFSETS):
    """Batched and sharded BC1 step: (B, 2N) words -> (B, 8N) rows, best (B,)."""
    return auto_step("bc1", mesh, candidates, offsets)


def bc2_auto_step(mesh, candidates=_BC2_CANDIDATES, offsets=DEFAULT_OFFSETS):
    """Batched and sharded BC2 step: (B, 4N) words -> (B, 16N) rows, best (B,)."""
    return auto_step("bc2", mesh, candidates, offsets)


def bc3_auto_step(mesh, candidates=_BC3_CANDIDATES, offsets=DEFAULT_OFFSETS):
    """Batched and sharded BC3 step: (B, 4N) words -> (B, 16N) rows, best (B,)."""
    return auto_step("bc3", mesh, candidates, offsets)


def bc4_auto_step(mesh, candidates=_BC4_CANDIDATES, offsets=DEFAULT_OFFSETS):
    """Batched and sharded BC4 step: (B, 2N) words -> (B, 8N) rows, best (B,)."""
    return auto_step("bc4", mesh, candidates, offsets)


def bc5_auto_step(mesh, candidates=_BC5_CANDIDATES, offsets=DEFAULT_OFFSETS):
    """Batched and sharded BC5 step: (B, 4N) words -> (B, 16N) rows, best (B,)."""
    return auto_step("bc5", mesh, candidates, offsets)


# --- BC7/BC6H mode sort and the load path, under a mesh -------------------------------

def modesort_transform_step(mesh, fmt: str = "bc7"):
    """Batched and sharded BC7/BC6H step (JAX ``sharded.py:931``): (B, 4·Np) block
    words and (B,) valid block counts -> ((B, 16, Np) byte planes, (B, Np/2) mode
    streams) of sort+planes, on ``mesh.home``. Np must be a multiple of 4096 times the
    blocks axis, so that every 4096-block sort chunk lies in one shard: each position
    sorts the valid blocks of each of its files by one ``dlt_bc7_transform`` launch.
    A file's blocks past its valid count keep their order after the sorted ones (one
    planes-only launch), and their mode nibbles are 0, as JAX's padding."""
    from ..ops.cuda import planes

    mesh_lib.require(mesh)
    if fmt not in ("bc7", "bc6h"):
        raise ValueError(f"mode sort is for bc7/bc6h, not {fmt}")
    fmt_id = planes.BC7 if fmt == "bc7" else planes.BC6H
    nb = mesh.shape["blocks"]

    def step(flat, valid_len):
        n_pad = flat.shape[1] // 4
        if n_pad % (planes.SORT_CHUNK_BLOCKS * nb):
            raise ValueError(f"{n_pad} blocks a file are no multiple of "
                             f"{planes.SORT_CHUNK_BLOCKS} x the blocks axis ({nb})")
        sh = _Shards(mesh, flat, [int(v) for v in valid_len], 4)
        bl, npl = sh.bl, sh.bc
        plane_shards, mode_shards = {}, {}
        for (f, s), x in sh.words.items():
            x = x.view(torch.uint8).reshape(bl, 16 * npl)
            ps = torch.empty((bl, 16, npl), dtype=torch.uint8, device=x.device)
            ms = torch.zeros((bl, npl // 2), dtype=torch.uint8, device=x.device)
            for lb in range(bl):
                v = min(max(sh.ns[f * bl + lb] - s * npl, 0), npl)
                if v:
                    out = planes.bc7_transform(x[lb, :16 * v], fmt_id, True, True)
                    msl = planes.mode_stream_len(v)
                    ms[lb, :msl] = out[:msl]
                    ps[lb, :, :v] = out[msl:].view(16, v)
                if v < npl:
                    ps[lb, :, v:] = planes.bc7_transform(x[lb, 16 * v:], fmt_id, False,
                                                         True).view(16, npl - v)
            plane_shards[f, s], mode_shards[f, s] = ps, ms
        return mesh.gather(plane_shards, 2), mesh.gather(mode_shards, 1)

    return step


def _untransform_kernel(fmt: str, settings):
    """(block size, stream spec, the untransform kernel on a flat payload)."""
    from ..ops import bc45, hostwrap
    from ..ops.cuda import shuffle

    v = int(getattr(settings, "decorrelation_mode", 0))
    return {
        "bc1": lambda: (8, hostwrap.bc1_stream_spec(settings), lambda x: shuffle.bc1_untransform(
            x, v, settings.split_colour_endpoints)),
        "bc2": lambda: (16, hostwrap.bc2_stream_spec(settings), lambda x: shuffle.bc2_untransform(
            x, v, settings.split_colour_endpoints)),
        "bc3": lambda: (16, hostwrap.bc3_stream_spec(settings), lambda x: shuffle.bc3_untransform(
            x, v, settings.split_alpha_endpoints, settings.split_colour_endpoints)),
        "bc4": lambda: (8, bc45.bc4_spec(settings.split_endpoints),
                        lambda x: shuffle.bc4_untransform(x, settings.split_endpoints)),
        "bc5": lambda: (16, bc45.bc5_spec(settings.split_endpoints),
                        lambda x: shuffle.bc5_untransform(x, settings.split_endpoints)),
    }[fmt]()


def untransform_step(mesh, fmt: str, settings):
    """Batched and sharded untransform step, the load path (JAX ``sharded.py:949``):
    per-stream (B, L_s) arrays (int32 words or uint8 bytes; stream s holds its bytes
    per block times n of each file) -> the (B, W) int32 block words, on ``mesh.home``.
    It is per file and per block: position (f, s) lays its files' blocks s·nc ..
    (s+1)·nc of every stream side by side, one valid transformed payload, and inverts
    them by one launch of the format's untransform kernel (the batched load path's
    layout). ``settings`` are the static settings of every file of the batch."""
    mesh_lib.require(mesh)
    block_size, spec, kernel = _untransform_kernel(fmt, settings)
    nf, nb = mesh.shape["files"], mesh.shape["blocks"]

    def step(*streams):
        if len(streams) != len(spec):
            raise ValueError(f"{fmt} {settings} has {len(spec)} streams, got {len(streams)}")
        B = streams[0].shape[0]
        rows = [st.contiguous().view(torch.uint8).reshape(B, -1) for st in streams]
        n = rows[0].shape[1] // spec[0]
        if B % nf or any(r.shape != (B, bpb * n) for r, bpb in zip(rows, spec)):
            raise ValueError(f"streams of shapes {[tuple(r.shape) for r in rows]} do not "
                             f"hold {B} files of one block count, or {B} files do not "
                             f"divide over the files axis of {nf}")
        if n == 0:
            return torch.empty((B, 0), dtype=torch.int32, device=mesh.home)
        bl, nc = B // nf, -(-n // nb)
        rows = [torch.cat([r, r.new_zeros((B, bpb * (nb * nc - n)))], dim=1)
                for r, bpb in zip(rows, spec)]
        out = {}
        for f, s in mesh.positions:
            device = mesh.devices[f, s]
            flat = torch.cat([r[f * bl:(f + 1) * bl, bpb * nc * s:bpb * nc * (s + 1)]
                              .to(device).reshape(-1) for r, bpb in zip(rows, spec)])
            out[f, s] = kernel(flat).view(bl, block_size * nc)
        return mesh.gather(out, 1)[:, :block_size * n].contiguous().view(torch.int32)

    return step
