"""Batched auto-search steps of the corpus pipeline (BC1-BC5), on one device.

Counterpart of the single-device parts of
``dxt_lossless_transform_tpu/parallel/sharded.py``: ``auto_step_batched`` (:855),
``auto_step_batched_regions`` (:833), ``_bc{1..5}_batched_impl`` (:542-687),
``_bc{1..5}_batched_regions_impl`` (:725-830), ``_colour_rows_batched`` (:500) and
``bc{1..5}_auto_step_single`` (:262-415, :689-714). A batch is a (B, W) int32
tensor of B files' block words, each file padded with zeros to the batch's bucket
of ``W / words per block`` blocks, and a (B,) list of valid lengths, ``4 n_b`` for a
file of ``n_b`` blocks (its colour region's bytes), as in the JAX package. Each step
returns what the JAX step returns, as tensors on the batch's device: the winner's
lanes, maximally split, and the winning candidate of each file (``best``); the
host-scored steps return every candidate's estimation-region row instead.

On the device each batch step runs:

1. ``deinterleave_words`` (``dlt_deinterleave_words``) on the whole flat batch;
2. the format's region kernel (``dlt_bc{1,2,3}_regions``) on the whole flat batch;
3. each file's rows cut out at its own valid length, in plain torch;
4. one count call (``dlt_ltu_counts_rows``) over every row of the batch, each at its
   own valid length;
5. the argmin per file, ties to the first candidate, and (BC1-BC3) the winner's
   decorrelation of each file's colours (:func:`..ops.ycocg.decorrelate_rows`).

The region kernel writes a split row of the flat batch as ``[c0 of all B·bucket
blocks | c1 of all]``: file b's c0 is at ``2·b·bucket … 2·(b·bucket + n_b)`` and its
c1 the same range ``2·B·bucket`` further on, so file b's row is ``c0[:2 n_b] ‖
c1[:2 n_b]``, not the bucket-padded pair (:func:`_put_split`); BC3's split alpha row
is the same with 1-byte lanes. BC4 and BC5 have no region kernel: their endpoint
rows come from the deinterleaved lanes (``sharded.py:640-687``). The tail of a row
past its valid length is never read. BC3 scores its alpha rows (``2 n_b`` valid)
and its colour rows (``4 n_b``) in the one call, BC5 its red and green endpoint rows
(summed per candidate, as the JAX batch step does).

Left out, for the multi-device layer: every step under a mesh
(``bc{1..5}_auto_step``, ``_scores_flat_shardmap``, ``_mesh_words_call``,
``modesort_transform_step``, ``untransform_step``). There is no words-path gate:
the kernels take any shape.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..estimate.ltu import DEFAULT_OFFSETS, coverage_scores
from ..ops import lanes, ycocg
from ..ops.auto import distinct
from ..ops.cuda import regions as cuda_regions
from ..ops.cuda.planes import deinterleave_words
from ..settings import (
    BC1_FAST_CANDIDATES, BC2_FAST_CANDIDATES, BC3_FAST_CANDIDATES,
    Bc4TransformSettings, Bc5TransformSettings,
)

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
    """Shared BC1/BC2 batch rows: (the deinterleaved lanes, (B, K, 4·bucket) colour
    rows of the K distinct candidate keys, each candidate's key index). Used by the
    device-scored and the host-scored steps, so that the two cannot diverge."""
    B, W = flats.shape
    bucket = W // wpb
    aux = _words(flats, wpb)
    keys, index = distinct(candidates)
    region = region_fn(flats.view(torch.uint8).reshape(-1), keys)
    rows = torch.empty((B, len(keys), 4 * bucket), dtype=torch.uint8,
                       device=flats.device)
    for c, (_, split) in enumerate(keys):
        if split:
            _put_split(rows[:, c], region[c].view(2, B, 2 * bucket), [2 * n for n in ns])
        else:
            rows[:, c] = region[c].view(B, 4 * bucket)
    return aux, rows, index


def _pick_and_decorrelate(colors, candidates, scores):
    """(B, C) scores -> (d0, d1, best): each file's first best candidate and its
    colour halves decorrelated with that candidate's variant."""
    best = torch.argmin(scores, dim=1)
    choices = [c[0] for c in candidates]
    variants = torch.tensor(choices).to(colors.device, non_blocking=True)[best]
    c0, c1 = lanes.split_u32(colors)
    return (ycocg.decorrelate_rows(c0, variants, choices),
            ycocg.decorrelate_rows(c1, variants, choices), best)


def _bc1_batched_impl(flats, valid_lens, candidates=_BC1_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    ns = _blocks(valid_lens)
    (colors, indices), rows, index = _colour_rows_batched(
        flats, ns, candidates, 2, cuda_regions.bc1_regions)
    scores = _scores(rows, [[4 * n] * rows.shape[1] for n in ns], offsets)[:, index]
    d0, d1, best = _pick_and_decorrelate(colors, candidates, scores)
    return d0, d1, indices, best


def _bc2_batched_impl(flats, valid_lens, candidates=_BC2_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    ns = _blocks(valid_lens)
    (a_lo, a_hi, colors, idx), rows, index = _colour_rows_batched(
        flats, ns, candidates, 4, cuda_regions.bc2_regions)
    scores = _scores(rows, [[4 * n] * rows.shape[1] for n in ns], offsets)[:, index]
    d0, d1, best = _pick_and_decorrelate(colors, candidates, scores)
    return a_lo, a_hi, d0, d1, idx, best


def _bc3_keys(candidates) -> tuple:
    alpha_keys, ai = distinct([sa for _, sa, _ in candidates])
    colour_keys, ci = distinct([(v, sc) for v, _, sc in candidates])
    return alpha_keys, colour_keys, ai, ci


def _bc3_rows(flats, ns, alpha_keys, colour_keys):
    """(lanes, (B, A+K, 4·bucket) rows): the A distinct alpha-endpoint rows (2·n_b
    bytes valid) then the K distinct colour rows (4·n_b)."""
    B, W4 = flats.shape
    bucket = W4 // 4
    w0, w1, colors, cidx = _words(flats, 4)
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
    return (w0, w1, colors, cidx), rows


def _bc3_batched_impl(flats, valid_lens, candidates=_BC3_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    ns = _blocks(valid_lens)
    alpha_keys, colour_keys, ai, ci = _bc3_keys(candidates)
    (w0, w1, colors, cidx), rows = _bc3_rows(flats, ns, alpha_keys, colour_keys)
    A = len(alpha_keys)
    scores = _scores(rows, [[2 * n] * A + [4 * n] * len(colour_keys) for n in ns],
                     offsets)
    scores = scores[:, ai] + scores[:, [A + c for c in ci]]
    ep, h1 = lanes.split_u32(w0)
    h2, h3 = lanes.split_u32(w1)
    d0, d1, best = _pick_and_decorrelate(colors, candidates, scores)
    return ep, h1, h2, h3, d0, d1, cidx, best


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
    ep, h1, h2, h3 = _bc4_lanes(flats)
    rows = _ep_rows(ep, ns, keys)
    scores = _scores(rows, [[2 * n] * len(keys) for n in ns], offsets)[:, index]
    return ep, h1, h2, h3, torch.argmin(scores, dim=1)


def _bc5_batched_impl(flats, valid_lens, candidates=_BC5_CANDIDATES,
                      offsets=DEFAULT_OFFSETS):
    """BC5: the red and the green endpoint rows scored apart and summed."""
    ns = _blocks(valid_lens)
    keys, index = distinct([split for split, in candidates])
    out = _bc5_lanes(flats)
    rows = torch.cat([_ep_rows(out[0], ns, keys), _ep_rows(out[1], ns, keys)], dim=1)
    K = len(keys)
    scores = _scores(rows, [[2 * n] * 2 * K for n in ns], offsets)
    scores = scores[:, :K] + scores[:, K:]
    return (*out, torch.argmin(scores[:, index], dim=1))


def _single(impl, flat, valid_len, wpb, candidates, offsets):
    n = flat.shape[0] // wpb
    valid = [4 * n if valid_len is None else int(valid_len)]
    return tuple(o[0] for o in impl(flat.view(1, -1), valid, candidates, offsets))


def bc1_auto_step_single(flat, valid_len=None, candidates=_BC1_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[2N] word image -> (c0, c1, indices, best)."""
    return _single(_bc1_batched_impl, flat, valid_len, 2, candidates, offsets)


def bc2_auto_step_single(flat, valid_len=None, candidates=_BC2_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (alpha_lo, alpha_hi, c0, c1, indices, best)."""
    return _single(_bc2_batched_impl, flat, valid_len, 4, candidates, offsets)


def bc3_auto_step_single(flat, valid_len=None, candidates=_BC3_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (ep, h1, h2, h3, c0, c1, cidx, best)."""
    return _single(_bc3_batched_impl, flat, valid_len, 4, candidates, offsets)


def bc4_auto_step_single(flat, valid_len=None, candidates=_BC4_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[2N] word image -> (ep, h1, h2, h3, best)."""
    return _single(_bc4_batched_impl, flat, valid_len, 2, candidates, offsets)


def bc5_auto_step_single(flat, valid_len=None, candidates=_BC5_CANDIDATES,
                         offsets=DEFAULT_OFFSETS):
    """Flat int32[4N] word image -> (r_ep, g_ep, R/G index lanes..., best)."""
    return _single(_bc5_batched_impl, flat, valid_len, 4, candidates, offsets)


# --- host-scored batched steps (zstd presets) ----------------------------------------
# A host estimator scores every candidate's estimation-region row, so these steps
# return the rows and the lanes the host needs to serialize the winner from its row
# (a candidate's region bytes are its on-disk colour, alpha or endpoint section).

def _per_candidate(rows, index):
    return rows if list(index) == list(range(rows.shape[1])) else rows[:, index]


def _bc1_batched_regions_impl(flats, valid_lens, candidates):
    (_, indices), rows, index = _colour_rows_batched(
        flats, _blocks(valid_lens), candidates, 2, cuda_regions.bc1_regions)
    return indices, _per_candidate(rows, index)


def _bc2_batched_regions_impl(flats, valid_lens, candidates):
    (a_lo, a_hi, _, idx), rows, index = _colour_rows_batched(
        flats, _blocks(valid_lens), candidates, 4, cuda_regions.bc2_regions)
    return a_lo, a_hi, idx, _per_candidate(rows, index)


def _bc3_batched_regions_impl(flats, valid_lens, candidates):
    """-> (h1, h2, h3, cidx, alpha rows of the distinct alpha keys, colour rows of
    the distinct colour keys)."""
    alpha_keys, colour_keys, _, _ = _bc3_keys(candidates)
    (w0, w1, _, cidx), rows = _bc3_rows(flats, _blocks(valid_lens), alpha_keys,
                                        colour_keys)
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


def check_mesh(mesh) -> None:
    """The multi-device layer is not ported: any mesh but None raises."""
    if mesh is not None:
        from ..errors import MultiDeviceNotPortedError

        raise MultiDeviceNotPortedError()


def auto_step_batched(fmt: str, candidates, offsets=DEFAULT_OFFSETS):
    """The device-scored batch step ``step(flats, valid_lens)`` of ``fmt`` (full and
    ragged batches alike: the JAX step's ``full`` shortcut has no counterpart)."""
    impl = _BATCHED_IMPLS[fmt]
    return lambda flats, valid_lens: impl(flats, valid_lens, tuple(candidates), offsets)


def auto_step_batched_regions(fmt: str, candidates, mesh=None):
    """The host-scored batch step ``step(flats, valid_lens)`` of ``fmt``: lanes and
    per-candidate region rows, no argmin."""
    check_mesh(mesh)
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
