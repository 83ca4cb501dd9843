"""The port's LTU scorer (plain version) against the JAX package's exact integer
numpy twin, its Pallas kernel in interpret mode and its XLA scorer, and the tables
that define the score."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.estimate import gtable as jax_gtable
from dxt_lossless_transform_tpu.estimate import ltu as jax_ltu
from dxt_lossless_transform_tpu.estimate.pallas_ltu import coverage_scores_pallas
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu, gtable, ltu


def _row(size: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(size)
    if kind == "random":
        return rng.integers(0, 256, size, np.uint8)
    # structured: a few symbols with runs and periodic repeats, so that every
    # offset finds matches
    base = rng.integers(0, 6, size, np.uint8)
    base[size // 3:size // 2] = 7
    period = np.tile(np.arange(48, dtype=np.uint8), size // 48 + 1)[:size]
    return np.where(np.arange(size) % 3 == 0, base, period).astype(np.uint8)


@pytest.mark.parametrize("kind", ["random", "structured"])
@pytest.mark.parametrize("size", [0, 1, 3, 4, 5, 4097, 4100, 70000])
def test_scores_equal_numpy_twin(size, kind):
    data = _row(size, kind)
    want = jax_ltu._coverage_score_np(data, jax_ltu.DEFAULT_OFFSETS)
    got = ltu.coverage_scores(torch.from_numpy(data.copy())[None, :], size)
    assert int(got[0]) == want
    # the same bytes in a longer row, with valid_len below the row length
    padded = np.concatenate([data, _row(37, "random")])[None, :]
    got = ltu.coverage_scores(torch.from_numpy(padded), size)
    assert int(got[0]) == want


@pytest.mark.parametrize("valid", [32768, 32768 - 999])
def test_scores_equal_pallas_interpret_and_xla(valid):
    rows8 = np.stack([_row(32768, "structured"), _row(32768, "random")])
    rows32 = np.stack([r.view("<u4") for r in rows8])
    offsets = jax_ltu.DEFAULT_OFFSETS
    pallas8 = np.asarray(coverage_scores_pallas(jnp.asarray(rows8), jnp.int32(valid),
                                                offsets, interpret=True))
    pallas32 = np.asarray(coverage_scores_pallas(jnp.asarray(rows32),
                                                 jnp.int32(valid), offsets,
                                                 interpret=True))
    xla = np.asarray(jax_ltu._coverage_scores(jnp.asarray(rows8), jnp.int32(valid),
                                              offsets))
    assert (pallas8 < 2**24).all()  # below 2**24 the f32 scores are exact integers
    got8 = ltu.coverage_scores(torch.from_numpy(rows8), valid).numpy()
    got32 = ltu.coverage_scores(torch.from_numpy(rows32.view(np.int32)), valid).numpy()
    for want in (pallas8, pallas32, xla):
        np.testing.assert_array_equal(got8, want.astype(np.int64))
    np.testing.assert_array_equal(got32, got8)


def test_tables_equal():
    np.testing.assert_array_equal(gtable.G_TABLE, jax_gtable.G_TABLE)
    assert gtable.ENTROPY_CAP == jax_gtable.ENTROPY_CAP
    assert ltu.DEFAULT_OFFSETS == jax_ltu.DEFAULT_OFFSETS
    assert ltu.WEIGHT_SCALE == jax_ltu.WEIGHT_SCALE
    assert all(ltu.offset_weight(k) == jax_ltu.offset_weight(k) for k in range(1, 5000))


@pytest.mark.parametrize("size", [0, 2, 1000, 9000])
def test_estimate_equals_jax_estimator(size):
    data = _row(size, "structured").tobytes()
    port = convert.from_reference(jax_ltu.LtuEstimation())
    assert port.estimate(data, device="cpu") == jax_ltu.LtuEstimation().estimate(data)


def test_custom_offsets_follow_the_estimator():
    data = _row(5000, "structured")
    offsets = (1, 7, 100, 3000)
    want = jax_ltu._coverage_score_np(data, offsets)
    est = convert.from_reference(jax_ltu.LtuEstimation(offsets))
    assert est.offsets == offsets
    assert est.estimate(data.tobytes(), device="cpu") == want


def test_scores_are_exact_above_2_pow_24():
    """A weighted total above 2**24 (where f32 sums round) stays exact."""
    size = 800_000
    data = np.zeros(size, np.uint8)
    counts = cuda_ltu.ltu_counts(torch.from_numpy(data)[None, :], size,
                                 [1], [ltu.offset_weight(1)])
    assert int(counts[0]) == 24 * (size - 4) > 2**24


FAR_OFFSETS = (1, 2, 4096, 4097, 8192, 65536)
LADDER_40 = tuple(sorted(set(jax_ltu.DEFAULT_OFFSETS) | {
    7, 9, 10, 11, 13, 14, 15, 20, 28, 40, 80, 160, 384, 768, 1536, 3072, 6144, 12288,
    24576, 49152}))


def _periodic(size: int, period: int) -> np.ndarray:
    """A row that repeats with ``period`` under 20% noise: matches at far offsets."""
    rng = np.random.default_rng(size + period)
    row = np.tile(rng.integers(0, 256, period, np.uint8), size // period + 1)[:size]
    noise = rng.random(size) < 0.2
    row[noise] = rng.integers(0, 3, int(noise.sum()))
    return row


@pytest.mark.parametrize("period", [4097, 8192, 65536])
@pytest.mark.parametrize("offsets", [FAR_OFFSETS, LADDER_40], ids=["far", "ladder40"])
def test_far_and_many_offsets_equal_numpy_twin(offsets, period):
    """Offsets beyond the kernel's 4096-byte halo, and more than 32 of them: the
    plain version equals the JAX package's numpy twin, as the estimator does."""
    assert len(LADDER_40) == 40
    data = _periodic(140_002, period)
    want = jax_ltu._coverage_score_np(data, offsets)
    got = ltu.coverage_scores(torch.from_numpy(data.copy())[None, :], data.size,
                              offsets)
    assert int(got[0]) == want
    est = convert.from_reference(jax_ltu.LtuEstimation(offsets))
    assert est.estimate(data.tobytes(), device="cpu") == want


def test_far_ladder_selects_the_far_kernel():
    """Offsets beyond 4096, 33 offsets and a negative weight take the generic kernel;
    the default ladder takes the default kernel."""
    ks = list(FAR_OFFSETS)
    ws = [ltu.offset_weight(k) for k in ks]
    assert not cuda_ltu.default_ladder(ks, ws)
    assert not cuda_ltu.default_ladder(list(LADDER_40[:33]), [1] * 33)
    assert not cuda_ltu.default_ladder([1, 2], [24, -1])
    assert cuda_ltu.default_ladder(list(ltu.DEFAULT_OFFSETS),
                                   [ltu.offset_weight(k) for k in ltu.DEFAULT_OFFSETS])


def test_negative_weights_are_summed_signed():
    data = np.zeros(100, np.uint8)
    counts = cuda_ltu.ltu_counts(torch.from_numpy(data)[None, :], 100, [1, 50], [-3, 5])
    assert int(counts[0]) == -3 * 96


@pytest.mark.parametrize("bad", [{"valid_len": 10}, {"offsets": [2, 1]},
                                 {"offsets": [0, 1]}, {"weights": [1]}])
def test_counts_reject_bad_arguments(bad):
    args = {"rows": torch.zeros((1, 8), dtype=torch.uint8), "valid_len": 8,
            "offsets": [1, 2], "weights": [24, 23], **bad}
    with pytest.raises(ValueError):
        cuda_ltu.ltu_counts(**args)


def test_offset_weight_formula():
    assert [ltu.offset_weight(k) for k in (1, 2, 3, 4096)] == [
        24, 23, 24 - int(round(math.log2(3))), 12]


@pytest.mark.parametrize("lengths", [[5000, 4097, 3, 0], [4100, 4100, 4100, 4100]])
def test_lengths_given_with_the_longest_count_as_host_lengths(lengths):
    """Lengths already on the rows' device with the longest from the host (a mesh
    step's one copy, :func:`cuda_ltu.device_lengths`) count as lengths on the host
    do, in the per-row and the windowed form, and so do the rows of a slice of them,
    which keep the longest of the whole; the rows' device is the CPU here."""
    rows = torch.from_numpy(_periodic(4 * 5000, 97).reshape(4, 5000).copy())
    ks = list(ltu.DEFAULT_OFFSETS)
    ws = [ltu.offset_weight(k) for k in ks]
    host = torch.tensor(lengths)
    given = cuda_ltu.device_lengths(host, rows.device)
    assert given.longest == max(lengths)
    assert torch.equal(cuda_ltu.ltu_counts(rows, given, ks, ws),
                       cuda_ltu.ltu_counts(rows, host, ks, ws))
    window = torch.nn.functional.pad(rows, (cuda_ltu.SPAN, cuda_ltu.SPAN))
    assert torch.equal(
        cuda_ltu.ltu_counts_windowed(window, given, -cuda_ltu.SPAN, ks, ws),
        cuda_ltu.ltu_counts_windowed(window, host, -cuda_ltu.SPAN, ks, ws))
    assert torch.equal(cuda_ltu.ltu_counts(rows[1:3], given.slice(1, 3), ks, ws),
                       cuda_ltu.ltu_counts(rows[1:3], host[1:3], ks, ws))


@pytest.mark.parametrize("given", [
    lambda: cuda_ltu.device_lengths(torch.tensor([10]), torch.device("cpu")),
    lambda: cuda_ltu.device_lengths(torch.tensor([10, 101]), torch.device("cpu")),
    lambda: cuda_ltu.device_lengths(torch.tensor([10, 10]), torch.device("meta")),
    lambda: cuda_ltu.device_lengths(torch.tensor([10, 10, 10]), torch.device("cpu")).slice(0, 1),
], ids=["one_row_for_two", "longest_past_the_row", "other_device", "short_slice"])
def test_given_lengths_are_checked(given):
    """Lengths passed with the longest (only ``device_lengths`` and their slices make
    them): the wrong shape or device, or a longest past the row, raise before any
    launch."""
    rows = torch.zeros((2, 100), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_ltu.ltu_counts(rows, given(), [1], [24])


@pytest.mark.parametrize("bad", [torch.tensor([[10, 10]]), torch.tensor([10, -1]),
                                 [10, 10]])
def test_device_lengths_checks_the_host_lengths(bad):
    """Lengths to copy must be one (C,) tensor on the host, none negative."""
    with pytest.raises(ValueError):
        cuda_ltu.device_lengths(bad, torch.device("cpu"))
