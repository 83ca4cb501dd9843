"""BC7 and BC6H mode-sort transforms, untransforms and auto-searches, bytes to bytes,
on the device.

Counterpart of ``dxt_lossless_transform_tpu/ops/bc7.py:315-599`` (shared by
``ops/bc6h.py``), with the host helpers of ``oracle/bc7.py:36-118`` and
``oracle/bc6h.py:29-41``: :data:`SORT_CHUNK_BLOCKS`, the mode tables and the stream
helpers, which sit beside the kernels' plain versions in :mod:`.cuda.planes`. For n
blocks the transformed payload is

    sort_by_mode:  [mode stream: ceil(n/2) bytes][16n bytes]
    otherwise:     [16n bytes]

where the 16n bytes are the blocks, stably sorted by mode id within 4096-block
chunks when sorting, as 16-byte blocks or as 16 byte planes. The identity setting
returns the payload without a launch; every other setting is one kernel launch on
the payload copied to the device once.

The auto-search follows the JAX package's ``_assemble_stream_row`` and
``_auto_device``: each distinct candidate's whole on-disk stream is one row, written
by one transform launch (the identity row is a copy of the payload), and the rows
are scored where they lie, in two groups of one length each, unsorted (16n bytes)
and sorted (16n + ceil(n/2)): two scoring calls. The corpus batch search
(:func:`auto_step_batched_modesort`) scores every file's rows in one call, each row
at its own length. Ties go to the first candidate; only the winner's
row comes back, and it is the output. Under :class:`~..estimate.ltu.LtuEstimation`
the pick then goes through :func:`ltu_identity_guard`, which needs the zstd library;
without it the search raises :class:`AutoTransformError`. Other estimators score
the same rows (a host-only one on the host) and get no guard, as in the JAX
package. An empty payload gives ``(b"", last candidate)``; a length that is not a
multiple of 16 raises the format's validation error.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import backend
from ..errors import AutoTransformError, Bc7ValidationError, ZstdUnavailableError
from ..estimate.base import SizeEstimation
from ..estimate.ltu import LtuEstimation, coverage_scores
from ..estimate.zstd import ZstdEstimation
from ..settings import BC7_FAST_CANDIDATES, Bc7TransformSettings
from .auto import distinct, score
from .cuda import planes
from .cuda.planes import (  # noqa: F401  (the host helpers, re-exported)
    BC6H, BC7, BLOCK_SIZE, MODE_TABLES, SORT_CHUNK_BLOCKS, mode_stream_len,
    pack_mode_stream, unpack_mode_stream,
)


def extract_msb_bits(byte, start: int, end: int):
    """Bits ``start``..``end`` of a byte in MSB order (position 0 is the most
    significant bit), right-aligned (JAX ``ops/bc7.py:47``). Elementwise on Python
    ints, numpy arrays and tensors."""
    assert 0 <= start <= end <= 7
    return (byte >> (7 - end)) & ((1 << (end - start + 1)) - 1)


def insert_msb_bits(byte, value, start: int, end: int):
    """``byte`` with bits ``start``..``end`` (MSB order) set to ``value`` (JAX
    ``ops/bc7.py:59``)."""
    assert 0 <= start <= end <= 7
    shift = 7 - end
    mask = ((1 << (end - start + 1)) - 1) << shift
    return (byte & ~mask & 0xFF) | ((value << shift) & mask)


def transformed_len(original_len: int, settings) -> int:
    """Transformed payload size of an ``original_len``-byte texture: the bytes
    themselves (a remainder past the last whole block included, as in
    ``oracle/bc7.py``) and, when sorting, the mode stream of the whole blocks."""
    n = original_len // BLOCK_SIZE
    return original_len + (mode_stream_len(n) if settings.sort_by_mode else 0)


def original_len(transformed: int, settings) -> int:
    """Inverse of :func:`transformed_len`; raises :class:`ValueError` where no block
    count fits."""
    if not settings.sort_by_mode:
        if transformed % BLOCK_SIZE:
            raise ValueError(f"transformed length {transformed} is not a block multiple")
        return transformed
    # 16n + ceil(n/2) == transformed, so n is near 2 * transformed / 33
    for n in (2 * transformed // 33, 2 * transformed // 33 + 1):
        if planes.transformed_len(n, True) == transformed:
            return BLOCK_SIZE * n
    raise ValueError(f"no block count matches transformed length {transformed}")


def _is_identity(settings) -> bool:
    return not settings.sort_by_mode and not settings.split_byte_planes


def transform_tensor(x: torch.Tensor, settings, fmt: int = BC7) -> torch.Tensor:
    """Blocks (uint8[16n], on any device) -> the transformed bytes; the identity
    setting returns ``x`` itself."""
    if _is_identity(settings):
        return x
    return planes.bc7_transform(x, fmt, settings.sort_by_mode, settings.split_byte_planes)


def untransform_tensor(x: torch.Tensor, settings) -> torch.Tensor:
    """Inverse of :func:`transform_tensor`."""
    if _is_identity(settings):
        return x
    n = original_len(x.numel(), settings) // BLOCK_SIZE
    return planes.bc7_untransform(x, n, settings.sort_by_mode, settings.split_byte_planes)


def transform_bytes(data, settings, fmt: int, error, device) -> bytes:
    if len(data) % BLOCK_SIZE:
        raise error(len(data), BLOCK_SIZE)
    dev = backend.resolve_device(device)
    if len(data) == 0 or _is_identity(settings):
        return bytes(data)
    return backend.download(transform_tensor(backend.upload(data, dev), settings, fmt))


def untransform_bytes(data, settings, error, device) -> bytes:
    dev = backend.resolve_device(device)
    try:
        original_len(len(data), settings)
    except ValueError as exc:
        raise error(len(data), BLOCK_SIZE, str(exc)) from None
    if len(data) == 0 or _is_identity(settings):
        return bytes(data)
    return backend.download(untransform_tensor(backend.upload(data, dev), settings))


def transform(data, settings: Bc7TransformSettings = Bc7TransformSettings(),
              device: Union[str, torch.device] = "cuda") -> bytes:
    """Interleaved BC7 blocks -> the mode-sorted and/or plane-split layout."""
    return transform_bytes(data, settings, BC7, Bc7ValidationError, device)


def untransform(data, settings: Bc7TransformSettings = Bc7TransformSettings(),
                device: Union[str, torch.device] = "cuda") -> bytes:
    """Bit-exact inverse of :func:`transform`."""
    return untransform_bytes(data, settings, Bc7ValidationError, device)


def ltu_identity_guard(data, out, settings, candidates) -> tuple:
    """The JAX package's selection policy for the mode-sort formats
    (``ops/bc7.py:510-553``): where the candidates hold the identity layout and the
    LTU winner is another, compress the winner and the untouched payload with
    zstd-1, and ship the winner only if it is strictly smaller. Returns
    ``(shipped bytes, shipped settings)``; raises :class:`ZstdUnavailableError`
    without the zstd library. The per-file form of :func:`ltu_identity_guard_batch`,
    so that the two decide alike."""
    return ltu_identity_guard_batch([data], [out], [settings], candidates)[0]


def ltu_identity_guard_batch(datas, outs, settings_list, candidates) -> list:
    """:func:`ltu_identity_guard` for many files (JAX ``ops/bc7.py:530``): every
    (winner, payload) pair that needs the check goes through one
    ``ZstdEstimation(1).estimate_batch`` call. Returns ``[(shipped bytes, shipped
    settings), ...]``; a reverted file ships its payload object itself where that is
    ``bytes``, and a copy otherwise."""
    ident = next((s for s in candidates if _is_identity(s)), None)
    results = list(zip(outs, settings_list))
    need = [i for i, (o, s) in enumerate(results)
            if ident is not None and s != ident and len(o)]
    if not need:
        return results
    sizes = ZstdEstimation(1).estimate_batch(
        [buf for i in need for buf in (outs[i], datas[i])])
    for j, i in enumerate(need):
        if not sizes[2 * j] < sizes[2 * j + 1]:
            data = datas[i]
            results[i] = (data if isinstance(data, bytes) else bytes(data), ident)
    return results


def stream_row_len(n_pad: int) -> int:
    """The JAX package's device-row length of a whole transformed stream of
    ``n_pad`` blocks (mode-stream bytes + 16 B/block, rounded up to its 32 KiB scoring
    tile; JAX ``ops/bc7.py:493``): the mode-sort batch's memory budget counts rows
    of this size, as in JAX."""
    span = 32 * 1024
    return -(-(n_pad // 2 + 16 * n_pad) // span) * span


def auto_step_batched_modesort(flats: torch.Tensor, n_valids, candidates, offsets,
                               fmt: int) -> tuple:
    """Batched BC7/BC6H search (JAX ``ops/bc7.py:452``): (B, 16·bucket) uint8 blocks,
    each file's block count ``n_valids[b]``, candidate keys ``((sort, planes), ...)``
    -> ((B, L) winner rows, (B,) their valid lengths, (B,) best candidates), on
    ``flats``' device. Each file's distinct candidates are written by the transform
    kernel into rows of one (B·K, L) tensor (the identity's row is a copy), and one
    count call scores every row at its own length: sorted rows are longer than
    unsorted ones. Ties go to the first candidate."""
    B = flats.shape[0]
    keys, index = distinct(list(candidates))
    ns = [int(n) for n in n_valids]
    L = max(planes.transformed_len(n, any(sort for sort, _ in keys)) for n in ns)
    rows = torch.empty((B, len(keys), L), dtype=torch.uint8, device=flats.device)
    valid = [[planes.transformed_len(n, sort) for sort, _ in keys] for n in ns]
    for b, n in enumerate(ns):
        x = flats[b, :BLOCK_SIZE * n]
        for k, (sort, split) in enumerate(keys):
            row = rows[b, k, :valid[b][k]]
            if sort or split:
                planes.bc7_transform(x, fmt, sort, split, out=row)
            else:
                row.copy_(x)
    lengths = torch.tensor(valid, dtype=torch.int64)
    scores = coverage_scores(rows.view(B * len(keys), L), lengths.view(-1),
                             offsets).view(B, -1)[:, index]
    best = torch.argmin(scores, dim=1)
    key_of = torch.tensor(index).to(flats.device, non_blocking=True)[best]
    picked = torch.arange(B, device=flats.device)
    return rows[picked, key_of], lengths.to(flats.device, non_blocking=True)[picked, key_of], best


def candidate_streams(x: torch.Tensor, fmt: int, estimator: SizeEstimation,
                      candidates, fmt_name: str) -> tuple:
    """``(scores, streams)``: each candidate's score on its whole transformed stream,
    and the stream (a device row) of each distinct ``(sort, planes)`` key. The
    unsorted and the sorted rows are scored as two groups."""
    n = x.numel() // BLOCK_SIZE
    keys, _ = distinct([(c.sort_by_mode, c.split_byte_planes) for c in candidates])
    scores, streams = {}, {}
    for sort in (False, True):
        group = [k for k in keys if k[0] == sort]
        if not group:
            continue
        length = planes.transformed_len(n, sort)
        rows = torch.empty((len(group), length), dtype=torch.uint8, device=x.device)
        for row, (_, split) in zip(rows, group):
            if sort or split:
                planes.bc7_transform(x, fmt, sort, split, out=row)
            else:
                row.copy_(x)
        for key, row, value in zip(group, rows,
                                   score(fmt_name, estimator, rows, length)):
            scores[key], streams[key] = value, row
    return np.array([scores[c.sort_by_mode, c.split_byte_planes] for c in candidates]), \
        streams


def transform_auto(data, estimator: SizeEstimation, candidates, fmt: int,
                   fmt_name: str, error, device):
    """The shared BC7/BC6H auto-search; returns ``(transformed, settings)``."""
    cand = tuple(candidates)
    dev = backend.resolve_device(device)
    if len(data) == 0:
        return b"", cand[-1]
    if len(data) % BLOCK_SIZE:
        raise error(len(data), BLOCK_SIZE)
    x = backend.upload(data, dev)
    scores, streams = candidate_streams(x, fmt, estimator, cand, fmt_name)
    best = cand[int(np.argmin(scores))]
    out = bytes(data) if _is_identity(best) else \
        backend.download(streams[best.sort_by_mode, best.split_byte_planes])
    if not isinstance(estimator, LtuEstimation):
        return out, best
    try:
        return ltu_identity_guard(data, out, best, cand)
    except ZstdUnavailableError as exc:
        raise AutoTransformError(fmt_name, f"the identity guard needs zstd: {exc}") \
            from exc


def transform_bc7_auto(data, estimator: SizeEstimation,
                       use_all_decorrelation_modes: bool = False,
                       candidates: Optional[Sequence[Bc7TransformSettings]] = None,
                       device: Union[str, torch.device] = "cuda"):
    """Pick the BC7 layout whose whole transformed stream the estimator ranks
    smallest; returns ``(transformed, settings)``. ``use_all_decorrelation_modes``
    is accepted for the builders' sake: the COMPREHENSIVE candidates are the FAST
    ones."""
    cand = candidates if candidates is not None else BC7_FAST_CANDIDATES
    return transform_auto(data, estimator, cand, BC7, "BC7", Bc7ValidationError,
                          device)
