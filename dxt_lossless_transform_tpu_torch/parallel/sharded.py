"""Batched auto-search steps of the corpus pipeline (BC1-BC5), on one device or
sharded over a mesh.

Counterpart of ``dxt_lossless_transform_tpu/parallel/sharded.py``: ``auto_step_batched``
(:855), ``auto_step_batched_regions`` (:833), ``_bc{1..5}_batched_impl`` (:542-687),
``_bc{1..5}_batched_regions_impl`` (:725-830), ``_colour_rows_batched`` (:500),
``bc{1..5}_auto_step_single`` (:262-415, :689-714), and under a mesh
``bc{1..5}_auto_step`` (:871-913), ``_scores_flat_shardmap`` (:427-473),
``_mesh_words_call`` (:190-227), ``modesort_transform_step`` (:931) and
``untransform_step`` (:949). A batch is a (B, W) int32 tensor of B files' block
words, each file padded with zeros to the batch's bucket of ``W / words per block``
blocks, and a (B,) list of valid lengths, ``4 n_b`` for a file of ``n_b`` blocks (its
colour region's bytes), as in the JAX package. The device-scored steps pick what the
JAX step picks, and return, as tensors on the batch's device (under a mesh, on
``mesh.home``), ``(rows, best)``: the winning candidate of each file (``best``) and
the (B, block_size·bucket) uint8 rows whose row b begins with file b's transformed
bytes under that candidate, the bytes JAX's pipeline serializes from its step's
lanes; the host-scored steps return lanes and every candidate's estimation-region
row, as JAX's do.

On one device each device-scored batch step runs:

1. the format's region kernel (``dlt_bc{1,2,3}_regions``) on the whole flat batch
   (BC4/BC5: ``deinterleave_words``, ``dlt_deinterleave_words``, and the endpoint
   rows in plain torch);
2. each file's rows cut out at its own valid length, in plain torch;
3. one count call (``dlt_ltu_counts_rows``) over every row of the batch, each at its
   own valid length;
4. the argmin per file, ties to the first candidate;
5. the format's rows kernel (``dlt_bc{1..5}_transform_rows``,
   :func:`..ops.cuda.shuffle.transform_rows`): each file's bytes under its winner.

The region kernel writes a split row of the flat batch as ``[c0 of all B·bucket
blocks | c1 of all]``: file b's c0 is at ``2·b·bucket … 2·(b·bucket + n_b)`` and its
c1 the same range ``2·B·bucket`` further on, so file b's row is ``c0[:2 n_b] ‖
c1[:2 n_b]``, not the bucket-padded pair (:func:`_put_split`); BC3's split alpha row
is the same with 1-byte lanes. BC4 and BC5 have no region kernel: their endpoint
rows come from the deinterleaved lanes (``sharded.py:640-687``). The tail of a row
past its valid length is never read. BC3 scores its alpha rows (``2 n_b`` valid)
and its colour rows (``4 n_b``) in the one call, BC5 its red and green endpoint rows
(summed per candidate, as the JAX batch step does).

Under a mesh (:mod:`.mesh`) the same steps run per shard and the scorer counts each
shard's chunk of the rows with its halos (``dlt_ltu_counts_windowed``); see the
section below. JAX's gates that send other shapes to a GSPMD XLA path have no
counterpart: the kernels take any shape, so a mesh step always runs the windowed
kernel, also on chunks shorter than its halo and buckets that the blocks axis does
not divide.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..estimate.cuda_ltu import SPAN, device_lengths, ltu_counts_windowed
from ..estimate.gtable import ENTROPY_CAP
from ..estimate.ltu import (
    DEFAULT_OFFSETS, WEIGHT_SCALE, coverage_scores, entropy_from_histograms,
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


def _scores(rows: torch.Tensor, valid: Sequence[Sequence[int]], offsets) -> torch.Tensor:
    """(B, R, L) rows, (B, R) valid lengths -> (B, R) exact scores, in one count
    call."""
    B, R, L = rows.shape
    lengths = torch.tensor(valid, dtype=torch.int64).view(B * R)
    return coverage_scores(rows.view(B * R, L), lengths, offsets).view(B, R)


def _colour_rows_batched(flats, ns, candidates, wpb: int, region_fn):
    """Shared BC1/BC2 batch rows: ((B, K, 4·bucket) colour rows of the K distinct
    candidate keys, each candidate's key index). Used by the device-scored and the
    host-scored steps, so that the two cannot diverge."""
    B, W = flats.shape
    bucket = W // wpb
    keys, index = distinct(candidates)
    region = region_fn(flats.view(torch.uint8).reshape(-1), keys)
    rows = torch.empty((B, len(keys), 4 * bucket), dtype=torch.uint8,
                       device=flats.device)
    for c, (_, split) in enumerate(keys):
        if split:
            _put_split(rows[:, c], region[c].view(2, B, 2 * bucket), [2 * n for n in ns])
        else:
            rows[:, c] = region[c].view(B, 4 * bucket)
    return rows, index


def _finish(fmt: str, flats, ns, candidates, scores) -> tuple:
    """(B, C) scores -> (rows, best): each file's first best candidate, and the
    batch's files transformed under theirs by the format's rows kernel."""
    best = torch.argmin(scores, dim=1)
    return transform_rows(fmt, flats, ns, best, candidates), best


def _bc1_batched_impl(flats, valid_lens, candidates=_BC1_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    ns = _blocks(valid_lens)
    rows, index = _colour_rows_batched(flats, ns, candidates, 2, cuda_regions.bc1_regions)
    scores = _scores(rows, [[4 * n] * rows.shape[1] for n in ns], offsets)[:, index]
    return _finish("bc1", flats, ns, candidates, scores)


def _bc2_batched_impl(flats, valid_lens, candidates=_BC2_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    ns = _blocks(valid_lens)
    rows, index = _colour_rows_batched(flats, ns, candidates, 4, cuda_regions.bc2_regions)
    scores = _scores(rows, [[4 * n] * rows.shape[1] for n in ns], offsets)[:, index]
    return _finish("bc2", flats, ns, candidates, scores)


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


def _bc3_batched_impl(flats, valid_lens, candidates=_BC3_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    ns = _blocks(valid_lens)
    alpha_keys, colour_keys, ai, ci = _bc3_keys(candidates)
    rows = _bc3_rows(flats, ns, alpha_keys, colour_keys)
    A = len(alpha_keys)
    scores = _scores(rows, [[2 * n] * A + [4 * n] * len(colour_keys) for n in ns],
                     offsets)
    return _finish("bc3", flats, ns, candidates,
                   scores[:, ai] + scores[:, [A + c for c in ci]])


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


def _bc4_lanes(flats):
    w0, w1 = _words(flats, 2)
    ep, h1 = lanes.split_u32(w0)
    h2, h3 = lanes.split_u32(w1)
    return ep, h1, h2, h3


def _bc5_lanes(flats):
    rw0, rw1, gw0, gw1 = _words(flats, 4)
    r_ep, rh1 = lanes.split_u32(rw0)
    rh2, rh3 = lanes.split_u32(rw1)
    g_ep, gh1 = lanes.split_u32(gw0)
    gh2, gh3 = lanes.split_u32(gw1)
    return r_ep, g_ep, rh1, rh2, rh3, gh1, gh2, gh3


def _bc4_batched_impl(flats, valid_lens, candidates=_BC4_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    """BC4: each candidate scored on its endpoint stream (2 bytes a block)."""
    ns = _blocks(valid_lens)
    keys, index = distinct([split for split, in candidates])
    ep, _ = lanes.split_u32(_words(flats, 2)[0])
    rows = _ep_rows(ep, ns, keys)
    scores = _scores(rows, [[2 * n] * len(keys) for n in ns], offsets)[:, index]
    return _finish("bc4", flats, ns, candidates, scores)


def _bc5_batched_impl(flats, valid_lens, candidates=_BC5_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    """BC5: the red and the green endpoint rows scored apart and summed."""
    ns = _blocks(valid_lens)
    keys, index = distinct([split for split, in candidates])
    rw0, _, gw0, _ = _words(flats, 4)
    rows = torch.cat([_ep_rows(lanes.split_u32(w)[0], ns, keys) for w in (rw0, gw0)],
                     dim=1)
    K = len(keys)
    scores = _scores(rows, [[2 * n] * 2 * K for n in ns], offsets)
    return _finish("bc5", flats, ns, candidates, (scores[:, :K] + scores[:, K:])[:, index])


def _single(impl, flat, valid_len, wpb, candidates, offsets):
    n = flat.shape[0] // wpb if valid_len is None else int(valid_len) // 4
    rows, best = impl(flat.view(1, -1), [4 * n], candidates, offsets)
    return rows[0, :4 * wpb * n], best[0]


def bc1_auto_step_single(flat, valid_len=None, candidates=_BC1_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[2N] word image -> (the transformed bytes of the first valid_len / 4
    blocks, all by default, under the winner: uint8[8n], best)."""
    return _single(_bc1_batched_impl, flat, valid_len, 2, candidates, offsets)


def bc2_auto_step_single(flat, valid_len=None, candidates=_BC2_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (transformed bytes uint8[16n], best)."""
    return _single(_bc2_batched_impl, flat, valid_len, 4, candidates, offsets)


def bc3_auto_step_single(flat, valid_len=None, candidates=_BC3_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (transformed bytes uint8[16n], best)."""
    return _single(_bc3_batched_impl, flat, valid_len, 4, candidates, offsets)


def bc4_auto_step_single(flat, valid_len=None, candidates=_BC4_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[2N] word image -> (transformed bytes uint8[8n], best)."""
    return _single(_bc4_batched_impl, flat, valid_len, 2, candidates, offsets)


def bc5_auto_step_single(flat, valid_len=None, candidates=_BC5_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (transformed bytes uint8[16n], best)."""
    return _single(_bc5_batched_impl, flat, valid_len, 4, candidates, offsets)


# --- host-scored batched steps (zstd presets) ----------------------------------------
# A host estimator scores every candidate's estimation-region row, so these steps
# return the rows and the lanes the host needs to serialize the winner from its row
# (a candidate's region bytes are its on-disk colour, alpha or endpoint section).

def _per_candidate(rows, index):
    return rows if list(index) == list(range(rows.shape[1])) else rows[:, index]


def _bc1_batched_regions_impl(flats, valid_lens, candidates):
    rows, index = _colour_rows_batched(flats, _blocks(valid_lens), candidates, 2,
                                       cuda_regions.bc1_regions)
    return _words(flats, 2)[1], _per_candidate(rows, index)


def _bc2_batched_regions_impl(flats, valid_lens, candidates):
    rows, index = _colour_rows_batched(flats, _blocks(valid_lens), candidates, 4,
                                       cuda_regions.bc2_regions)
    a_lo, a_hi, _, idx = _words(flats, 4)
    return a_lo, a_hi, idx, _per_candidate(rows, index)


def _bc3_batched_regions_impl(flats, valid_lens, candidates):
    """-> (h1, h2, h3, cidx, alpha rows of the distinct alpha keys, colour rows of
    the distinct colour keys)."""
    alpha_keys, colour_keys, _, _ = _bc3_keys(candidates)
    rows = _bc3_rows(flats, _blocks(valid_lens), alpha_keys, colour_keys)
    w0, w1, _, cidx = _words(flats, 4)
    A, bucket = len(alpha_keys), flats.shape[1] // 4
    _, h1 = lanes.split_u32(w0)
    h2, h3 = lanes.split_u32(w1)
    return h1, h2, h3, cidx, rows[:, :A, :2 * bucket], rows[:, A:]


def _bc4_batched_regions_impl(flats, valid_lens, candidates):
    keys, index = distinct([split for split, in candidates])
    ep, h1, h2, h3 = _bc4_lanes(flats)
    return h1, h2, h3, _per_candidate(_ep_rows(ep, _blocks(valid_lens), keys), index)


def _bc5_batched_regions_impl(flats, valid_lens, candidates):
    keys, index = distinct([split for split, in candidates])
    r_ep, g_ep, *idx = _bc5_lanes(flats)
    ns = _blocks(valid_lens)
    return (*idx, _per_candidate(_ep_rows(r_ep, ns, keys), index),
            _per_candidate(_ep_rows(g_ep, ns, keys), index))


_BATCHED_IMPLS = {"bc1": _bc1_batched_impl, "bc2": _bc2_batched_impl,
                  "bc3": _bc3_batched_impl, "bc4": _bc4_batched_impl,
                  "bc5": _bc5_batched_impl}
_BATCHED_REGIONS_IMPLS = {"bc1": _bc1_batched_regions_impl,
                          "bc2": _bc2_batched_regions_impl,
                          "bc3": _bc3_batched_regions_impl,
                          "bc4": _bc4_batched_regions_impl,
                          "bc5": _bc5_batched_regions_impl}


def auto_step_batched(fmt: str, candidates, offsets=DEFAULT_OFFSETS):
    """The device-scored batch step ``step(flats, valid_lens)`` of ``fmt`` (full and
    ragged batches alike: the JAX step's ``full`` shortcut has no counterpart)."""
    impl = _BATCHED_IMPLS[fmt]
    return lambda flats, valid_lens: impl(flats, valid_lens, tuple(candidates), offsets)


def auto_step_batched_regions(fmt: str, candidates, mesh=None):
    """The host-scored batch step ``step(flats, valid_lens)`` of ``fmt``: lanes and
    per-candidate region rows, no argmin; under a ``mesh``, the words sharded over
    it (:func:`_mesh_regions_step`)."""
    if mesh is not None:
        return _mesh_regions_step(fmt, mesh, candidates)
    impl = _BATCHED_REGIONS_IMPLS[fmt]
    return lambda flats, valid_lens: impl(flats, valid_lens, tuple(candidates))


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
# JAX's halo ``ppermute`` and ``psum`` (:427-473). Every output is gathered onto
# ``mesh.home``, whole, as ``jax.device_get`` of the global arrays gives it.

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

    def rows(self, group) -> torch.Tensor:
        """A row group's whole rows, (B, labels, U·blocks) on home, by label (the
        host-scored steps' region rows)."""
        blocks, labels = group
        mesh, some = self.mesh, next(iter(blocks.values()))
        per_block = sum(u for _, u in some[0])
        chunks = {pos: torch.zeros((self.bl, len(labels), per_block * self.bc),
                                   dtype=torch.uint8, device=mesh.devices[pos])
                  for pos in mesh.positions}
        for moves in self.chunk_moves(blocks, chunks.__getitem__):
            mesh.run(moves)
        rows = mesh.gather(chunks, 2)[:, :, :per_block * self.n_blocks]
        return rows[:, [labels.index(c) for c in range(len(labels))]]

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


def _colour_local(fmt: str, wpb: int):
    """BC1/BC2 shard: (its lanes when asked, [the colour rows of the distinct keys])."""
    def local(x, bl, keys, want_lanes):
        region = getattr(cuda_regions, f"{fmt}_regions")(x.view(torch.uint8).reshape(-1),
                                                         keys[0])
        return (_words(x, wpb) if want_lanes else None,
                [_split_rows(region, _splits(keys[0]), bl, 4)])
    return local


def _bc3_local(x, bl, keys, want_lanes):
    alpha_keys, colour_keys = keys[:2]
    alpha, colour = cuda_regions.bc3_regions(x.view(torch.uint8).reshape(-1), alpha_keys,
                                             colour_keys)
    return (_words(x, 4) if want_lanes else None,
            [_split_rows(alpha, alpha_keys, bl, 2),
             _split_rows(colour, _splits(colour_keys), bl, 4)])


def _bc4_local(x, bl, keys, want_lanes):
    out = _bc4_lanes(x)
    return out, [_split_rows(_ep_region(out[0], keys[0]), keys[0], bl, 2)]


def _bc5_local(x, bl, keys, want_lanes):
    """The red then the green endpoint rows, in one group: labels K.. are green."""
    out = _bc5_lanes(x)
    red, red_order = _split_rows(_ep_region(out[0], keys[0]), keys[0], bl, 2)
    green, green_order = _split_rows(_ep_region(out[1], keys[0]), keys[0], bl, 2)
    k = len(keys[0])
    return out, [(red + green, red_order + [k + c for c in green_order])]


def _bc3_aux(out):
    w0, w1, _, cidx = out
    _, h1 = lanes.split_u32(w0)
    h2, h3 = lanes.split_u32(w1)
    return h1, h2, h3, cidx


def _bc5_pick(scores, keys):
    k = len(keys[0])
    return (scores[0][:, :k] + scores[0][:, k:])[:, keys[1]]


def _distinct_splits(candidates) -> tuple:
    return distinct([split for split, in candidates])


# per format: words per block, the candidates' keys, a shard's lanes and row groups,
# the candidate scores from the groups' scores; host-scored: which lanes go back, and
# the region rows from the groups' rows
_MESH_FORMATS = {
    "bc1": dict(words=2, keys=distinct, local=_colour_local("bc1", 2),
                pick=lambda sc, keys: sc[0][:, keys[1]], aux=lambda out: out[1:],
                rows=lambda rows, keys: [_per_candidate(rows[0], keys[1])]),
    "bc2": dict(words=4, keys=distinct, local=_colour_local("bc2", 4),
                pick=lambda sc, keys: sc[0][:, keys[1]],
                aux=lambda out: (out[0], out[1], out[3]),
                rows=lambda rows, keys: [_per_candidate(rows[0], keys[1])]),
    "bc3": dict(words=4, keys=_bc3_keys, local=_bc3_local,
                pick=lambda sc, keys: sc[0][:, keys[2]] + sc[1][:, keys[3]],
                aux=_bc3_aux, rows=lambda rows, keys: rows),
    "bc4": dict(words=2, keys=_distinct_splits, local=_bc4_local,
                pick=lambda sc, keys: sc[0][:, keys[1]], aux=lambda out: out[1:],
                rows=lambda rows, keys: [_per_candidate(rows[0], keys[1])]),
    "bc5": dict(words=4, keys=_distinct_splits, local=_bc5_local, pick=_bc5_pick,
                aux=lambda out: out[2:],
                rows=lambda rows, keys: [
                    _per_candidate(rows[0][:, :len(keys[0])], keys[1]),
                    _per_candidate(rows[0][:, len(keys[0]):], keys[1])]),
}


def _mesh_local(sh: _Shards, spec, keys, want_lanes: bool) -> tuple:
    """Each position's lanes (when asked; BC4/BC5 always), and the row groups:
    [(row blocks by position, labels)]."""
    out = {pos: spec["local"](x, sh.bl, keys, want_lanes) for pos, x in sh.words.items()}
    some = next(iter(out.values()))[1]
    return ({pos: o[0] for pos, o in out.items()},
            [({pos: o[1][g][0] for pos, o in out.items()}, labels)
             for g, (_, labels) in enumerate(some)])


def auto_step(fmt: str, mesh, candidates, offsets=DEFAULT_OFFSETS):
    """The device-scored batch step ``step(flats, valid_lens)`` of ``fmt`` under a
    mesh: what :func:`auto_step_batched` returns, as tensors on ``mesh.home``. The
    scores come from the shards; the format's rows kernel then transforms the batch
    on ``mesh.home`` (each rank holds the whole batch). The batch's file count must
    be a multiple of the files axis."""
    mesh_lib.require(mesh)
    spec, candidates = _MESH_FORMATS[fmt], tuple(candidates)

    def step(flats, valid_lens):
        ns = _blocks(valid_lens)
        sh = _Shards(mesh, flats, ns, spec["words"])
        keys = spec["keys"](candidates)
        _, groups = _mesh_local(sh, spec, keys, False)
        scores = spec["pick"]([sh.scores(group, offsets) for group in groups], keys)
        return _finish(fmt, flats.to(mesh.home), ns, candidates, scores)

    return step


def _mesh_regions_step(fmt: str, mesh, candidates):
    """The host-scored batch step of ``fmt`` under a mesh: what
    :func:`auto_step_batched_regions` returns without one, on ``mesh.home``."""
    mesh_lib.require(mesh)
    spec, candidates = _MESH_FORMATS[fmt], tuple(candidates)

    def step(flats, valid_lens):
        sh = _Shards(mesh, flats, _blocks(valid_lens), spec["words"])
        keys = spec["keys"](candidates)
        lanes_of, groups = _mesh_local(sh, spec, keys, True)
        aux = {pos: spec["aux"](out) for pos, out in lanes_of.items()}
        width = len(next(iter(aux.values())))
        return (*(sh.gather({pos: out[i] for pos, out in aux.items()})
                  for i in range(width)),
                *spec["rows"]([sh.rows(group) for group in groups], keys))

    return step


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
