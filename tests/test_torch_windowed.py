"""The port's windowed count (``estimate/cuda_ltu.py`` ``ltu_counts_windowed``, the
partial count of one shard of the mesh scorer; its plain version on the CPU) against
the JAX package's ``coverage_counts_windowed(..., interpret=True)``, shard by shard,
and the shards' sum against the uncut row's count. Rows are random low-entropy bytes
from numpy seeds, so that the offsets match; valid lengths are ragged (0-3 among
them); every comparison is exact (all counts below 2**24, where JAX's f32 sums are
exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.estimate.ltu import DEFAULT_OFFSETS as JAX_OFFSETS
from dxt_lossless_transform_tpu.estimate.pallas_ltu import SPAN as JAX_SPAN
from dxt_lossless_transform_tpu.estimate.pallas_ltu import coverage_counts_windowed
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
from dxt_lossless_transform_tpu_torch.estimate.ltu import DEFAULT_OFFSETS, offset_weight

SPAN = cuda_ltu.SPAN
KS = tuple(sorted(DEFAULT_OFFSETS))
# an offset beyond the near kernel's 4096-byte halo, within the shard's SPAN (JAX
# takes offsets above one 1024-byte lane row only as multiples of it)
FAR = KS + (8192, SPAN)


def _windows(rows: np.ndarray, nb: int):
    """(C, nb·Lc) rows -> each shard's (C, SPAN + Lc + SPAN) window and its pos0: the
    head halo of shard 0 zeros, the last shard's tail halo zeros."""
    c, length = rows.shape
    lc = length // nb
    padded = np.concatenate([np.zeros((c, SPAN), np.uint8), rows,
                             np.zeros((c, SPAN), np.uint8)], axis=1)
    return [(padded[:, s * lc:s * lc + lc + 2 * SPAN], s * lc - SPAN) for s in range(nb)]


def _valid(length: int) -> np.ndarray:
    return np.asarray([length, length - 1001, 0, 3, 4, 7, length // 3, length - 1],
                      np.int32)


@pytest.mark.parametrize("ladder", [KS, FAR], ids=["default", "far"])
@pytest.mark.parametrize("words", [False, True], ids=["u8", "u32"])
@pytest.mark.parametrize("nb,tiles", [(1, 1), (2, 1), (4, 2), (8, 1)])
def test_windowed_matches_jax_and_sums_to_the_uncut_count(nb, tiles, words, ladder):
    assert SPAN == JAX_SPAN
    length = nb * tiles * SPAN
    rows = np.random.default_rng(nb * 10 + tiles).integers(0, 3, (8, length), np.uint8)
    valid = _valid(length)
    ws = [offset_weight(k) for k in ladder]
    total = torch.zeros(len(valid), dtype=torch.int64)
    for win, pos0 in _windows(rows, nb):
        win = np.ascontiguousarray(win)
        arg = win.view("<u4") if words else win
        want = np.asarray(coverage_counts_windowed(jnp.asarray(arg), jnp.asarray(valid),
                                                   pos0, ladder, interpret=True))
        got = cuda_ltu.ltu_counts_windowed(
            torch.from_numpy(arg.view(np.int32) if words else arg),
            torch.from_numpy(valid), pos0, ladder, ws)
        assert got.dtype == torch.int64
        assert want.max() < 2 ** 24
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        total += got
    uncut = cuda_ltu.ltu_counts_plain(torch.from_numpy(rows), torch.from_numpy(valid).long(),
                                      ladder, ws)
    assert torch.equal(total, uncut)


def test_default_ladder_is_jax_s():
    assert tuple(sorted(JAX_OFFSETS)) == KS


def test_chunks_shorter_than_the_halo_sum_to_the_uncut_count():
    """Chunks of 1 KiB (a 2,048-block BC1 bucket at 8 shards): each halo spans
    several shards."""
    nb, lc = 8, 1024
    rows = np.random.default_rng(5).integers(0, 3, (4, nb * lc), np.uint8)
    valid = np.asarray([nb * lc, nb * lc - 5, 2000, 2], np.int64)
    ws = [offset_weight(k) for k in FAR]
    total = sum(cuda_ltu.ltu_counts_windowed(torch.from_numpy(np.ascontiguousarray(w)),
                                             torch.from_numpy(valid), pos0, FAR, ws)
                for w, pos0 in _windows(rows, nb))
    assert torch.equal(total, cuda_ltu.ltu_counts_plain(
        torch.from_numpy(rows), torch.from_numpy(valid), FAR, ws))


def test_an_offset_beyond_the_halo_raises():
    rows = torch.zeros((1, 2 * SPAN + 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="halo"):
        cuda_ltu.ltu_counts_windowed(rows, torch.tensor([8]), -SPAN, (1, SPAN + 1), (24, 9))


@pytest.mark.parametrize("rows,valid", [
    (torch.zeros((2, 2 * SPAN + 8), dtype=torch.uint8), torch.tensor([8])),
    (torch.zeros((1, 2 * SPAN - 1), dtype=torch.uint8), torch.tensor([8])),
], ids=["valid-shape", "no-room-for-halos"])
def test_bad_windows_raise(rows, valid):
    with pytest.raises(ValueError):
        cuda_ltu.ltu_counts_windowed(rows, valid, -SPAN, KS, [offset_weight(k) for k in KS])
