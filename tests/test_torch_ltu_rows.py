"""The port's LTU scorer with one valid length per row (``estimate/cuda_ltu.py``,
``estimate/ltu.py``, ``estimate/base.py``; plain versions on the CPU) against the JAX
package's per-row scorer, ``coverage_scores_pallas(rows, valid_rows, offsets)`` in
interpret mode, at sizes where its f32 sums are exact (below 2**24), and against the
port's own scalar form row by row. Rows are random low-entropy bytes from numpy, so
that the offsets match; every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.estimate.ltu import DEFAULT_OFFSETS as JAX_OFFSETS
from dxt_lossless_transform_tpu.estimate.pallas_ltu import SPAN, coverage_scores_pallas
from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
from dxt_lossless_transform_tpu_torch.estimate.base import SizeEstimation
from dxt_lossless_transform_tpu_torch.estimate.ltu import (
    DEFAULT_OFFSETS, LtuEstimation, coverage_scores, entropy_terms, offset_weight,
)
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation

KS = sorted(DEFAULT_OFFSETS)
WS = [offset_weight(k) for k in KS]
# valid lengths from 0 to the row's length: 0-3 (no whole gram), odd, a few past
# the nearest offsets, and lengths within the far offsets' reach
LENGTHS = [0, 1, 2, 3, 4, 5, 7, 100, 999, 4099, 8195, 20_001, SPAN - 1, SPAN, 2 * SPAN]


def _rows(count: int, length: int, seed: int, top: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, top, (count, length), np.uint8)


def test_scores_match_pallas_per_row_interpret():
    rows = _rows(len(LENGTHS), 2 * SPAN, 1)
    valid = np.asarray(LENGTHS, np.int32)
    want = np.asarray(coverage_scores_pallas(jnp.asarray(rows), jnp.asarray(valid),
                                             JAX_OFFSETS, interpret=True))
    got = coverage_scores(torch.from_numpy(rows), torch.from_numpy(valid))
    assert got.dtype == torch.int64
    assert want.max() < 2 ** 24  # where the JAX sums are exact
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_word_rows_score_as_their_bytes_per_row():
    rows = _rows(4, 2 * SPAN, 2)
    valid = torch.tensor([2 * SPAN, 2 * SPAN - 3, 17, 0])
    words = torch.from_numpy(rows.view("<i4"))
    bytes_ = torch.from_numpy(rows)
    assert torch.equal(coverage_scores(words, valid), coverage_scores(bytes_, valid))


@pytest.mark.parametrize("offsets", [tuple(KS), (1, 2, 4096, 4097, 8192, 65536),
                                     (3, 5, 1000)],
                         ids=["default", "far", "short"])
def test_counts_per_row_equal_the_scalar_form_row_by_row(offsets):
    rows = torch.from_numpy(_rows(len(LENGTHS), 2 * SPAN, 3, top=3))
    ws = [offset_weight(k) for k in offsets]
    valid = torch.tensor(LENGTHS)
    got = cuda_ltu.ltu_counts(rows, valid, offsets, ws)
    want = [int(cuda_ltu.ltu_counts(rows[r:r + 1], v, offsets, ws)[0])
            for r, v in enumerate(LENGTHS)]
    assert got.tolist() == want
    assert all(got[r] == 0 for r, v in enumerate(LENGTHS) if v < 4)


def test_negative_weights_per_row():
    rows = torch.from_numpy(_rows(3, 5000, 4, top=2))
    offsets, ws = (1, 2, 3), (-5, 7, -255)
    valid = torch.tensor([5000, 4, 77])
    got = cuda_ltu.ltu_counts(rows, valid, offsets, ws)
    want = [int(cuda_ltu.ltu_counts(rows[r:r + 1], int(v), offsets, ws)[0])
            for r, v in enumerate(valid)]
    assert got.tolist() == want


def test_scores_per_row_equal_the_scalar_form_row_by_row():
    rows = torch.from_numpy(_rows(len(LENGTHS), 2 * SPAN, 5, top=6))
    got = coverage_scores(rows, torch.tensor(LENGTHS))
    want = [int(coverage_scores(rows[r:r + 1], v)[0]) for r, v in enumerate(LENGTHS)]
    assert got.tolist() == want


def test_entropy_terms_leave_out_every_byte_past_the_prefix():
    """Each row's histogram holds its own first min(valid, 65536) bytes only: the
    bytes after them, set to 0 here in one copy and to 255 in the other, change
    nothing."""
    base = _rows(6, 70_000, 6, top=200)
    valid = [0, 1, 2, 1000, 65_536, 69_999]
    a, b = base.copy(), base.copy()
    for r, v in enumerate(valid):
        a[r, v:], b[r, v:] = 0, 255
    ta = entropy_terms(torch.from_numpy(a), torch.tensor(valid))
    tb = entropy_terms(torch.from_numpy(b), torch.tensor(valid))
    assert torch.equal(ta, tb)
    want = [int(entropy_terms(torch.from_numpy(a[r:r + 1]), v)[0])
            for r, v in enumerate(valid)]
    assert ta.tolist() == want
    assert ta[0] == ta[1] == 0


def test_ltu_estimator_scores_rows_at_their_own_lengths():
    rows = torch.from_numpy(_rows(3, 9000, 7))
    valid = torch.tensor([9000, 4500, 3])
    got = LtuEstimation().estimate_batch_device(rows, valid)
    assert got.tolist() == [LtuEstimation().estimate(rows[r, :v].numpy().tobytes(),
                                                     device="cpu")
                            for r, v in enumerate(valid.tolist())]


class _LengthOnly(SizeEstimation):
    """A host-only estimator: the length of each buffer."""

    def estimate(self, data) -> int:
        return len(data)


def test_host_estimators_score_each_rows_prefix():
    rows = torch.from_numpy(_rows(3, 64, 8, top=256))
    valid = torch.tensor([64, 10, 0])
    assert _LengthOnly().estimate_batch_device(rows, valid).tolist() == [64, 10, 0]
    zstd = ZstdEstimation(1)
    got = zstd.estimate_batch_device(rows, valid).tolist()
    assert got == [zstd.estimate(rows[r, :v].numpy().tobytes())
                   for r, v in enumerate(valid.tolist())]


@pytest.mark.parametrize("count,valid", [(3, [1, 2]), (2, [5, -1]), (2, [5, 65])],
                         ids=["too-few", "negative", "past-the-row"])
def test_per_row_lengths_are_checked(count, valid):
    rows = torch.zeros((count, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_ltu.ltu_counts(rows, torch.tensor(valid), KS, WS)


def test_per_row_cpu_takes_the_plain_version():
    backend.reset_launch_counts()
    rows = torch.from_numpy(_rows(2, 100, 9))
    cuda_ltu.ltu_counts(rows, torch.tensor([100, 50]), KS, WS)
    assert all(count == 0 for count in backend.LAUNCHES.values())


@pytest.mark.parametrize("longest", [0, 4, 5, 4098, 4099, 4100])
def test_row_lengths_refuse_a_longest_given_by_hand(longest):
    """Lengths on the rows' device carry the longest read from the host: one given by
    hand is refused, whether too small (it would shrink the grid and count the rows
    only in part), right or too large. ``device_lengths`` takes it from the lengths it
    copies, and a slice keeps the whole set's, an upper bound; both count as the host
    lengths do."""
    host = torch.tensor([5, 4099, 7])
    with pytest.raises(TypeError):
        cuda_ltu.RowLengths(host, longest)
    made = cuda_ltu.device_lengths(host, torch.device("cpu"))
    assert made.longest == 4099 and made.slice(1, 3).longest == 4099
    rows = torch.from_numpy(_rows(3, 4099, longest))
    assert torch.equal(cuda_ltu.ltu_counts(rows, made, KS, WS),
                       cuda_ltu.ltu_counts(rows, host, KS, WS))
