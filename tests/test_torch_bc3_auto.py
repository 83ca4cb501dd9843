"""The port's BC3 auto-search (plain versions, ``device="cpu"``) against the JAX
package: its deduplicated regions, its exact integer scores, its picks and its
bytes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.estimate.base import NoEstimation as JaxNoEstimation
from dxt_lossless_transform_tpu.estimate.ltu import (
    DEFAULT_OFFSETS, LtuEstimation as JaxLtu, _coverage_score_np,
)
from dxt_lossless_transform_tpu.ops import auto as jax_auto, lanes
from dxt_lossless_transform_tpu.ops.pallas.regions import bc3_region_streams_tpu
from dxt_lossless_transform_tpu.settings import (
    BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES, Bc3TransformSettings,
    YCoCgVariant,
)
from dxt_lossless_transform_tpu.utils.testgen import bc3_realistic
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import AutoTransformError, Bc3ValidationError
from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.ops import auto, bc3
from dxt_lossless_transform_tpu_torch.ops.cuda import regions

EXPLICIT = (
    Bc3TransformSettings(YCoCgVariant.VARIANT3, False, True),
    Bc3TransformSettings(YCoCgVariant.NONE, True, False),
    Bc3TransformSettings(YCoCgVariant.VARIANT2, True, True),
    Bc3TransformSettings(YCoCgVariant.VARIANT3, True, True),
)
CANDIDATES = {"fast": None, "comprehensive": None, "explicit": EXPLICIT}
SETS = {"fast": BC3_FAST_CANDIDATES, "comprehensive": BC3_COMPREHENSIVE_CANDIDATES,
        "explicit": EXPLICIT}


def _data(n: int, kind: str = "realistic") -> bytes:
    if kind == "realistic":
        return bc3_realistic(n, seed=3)
    return np.random.default_rng(n).integers(0, 256, 16 * n, np.uint8).tobytes()


def _tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _reference_scores(data: bytes, cand) -> list:
    """Each candidate's alpha-region plus colour-region score from the JAX
    package's exact numpy twin, over its own (not deduplicated) rows."""
    words = np.frombuffer(data, "<u4").reshape(-1, 4)
    ep = (words[:, 0] & 0xFFFF).astype(np.int64)
    alpha = {False: ep.astype("<u2").tobytes(),
             True: (ep & 0xFF).astype(np.uint8).tobytes()
             + (ep >> 8).astype(np.uint8).tobytes()}
    key = [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand]
    colour = jax_auto._host_colour_regions(words[:, 2].copy(), key)

    def score(row):
        return _coverage_score_np(np.frombuffer(row, np.uint8), DEFAULT_OFFSETS)

    return [score(alpha[c.split_alpha_endpoints]) + score(row)
            for c, row in zip(cand, colour)]


@pytest.mark.parametrize("n", [1, 1000, 40000])
@pytest.mark.parametrize("which", CANDIDATES)
def test_pick_bytes_and_scores_match_jax(which, n):
    data = _data(n)
    use_all = which == "comprehensive"
    cand = CANDIDATES[which]
    want, want_s = jax_auto.transform_bc3_auto(data, JaxLtu(), use_all, cand)
    got, got_s = auto.transform_bc3_auto(
        data, convert.from_reference(JaxLtu()), use_all,
        None if cand is None else convert.from_reference(cand), device="cpu")
    assert got_s == convert.from_reference(want_s)
    assert got == want
    scores = auto.bc3_candidate_scores(_tensor(data), convert.from_reference(JaxLtu()),
                                       convert.from_reference(SETS[which]))
    assert scores.dtype == np.int64
    assert scores.tolist() == _reference_scores(data, SETS[which])
    assert SETS[which][int(np.argmin(scores))] == want_s


@pytest.mark.parametrize("which", CANDIDATES)
def test_pick_and_bytes_match_jax_random_blocks(which):
    data = _data(777, "random")
    use_all = which == "comprehensive"
    cand = CANDIDATES[which]
    want, want_s = jax_auto.transform_bc3_auto(data, JaxLtu(), use_all, cand)
    got, got_s = auto.transform_bc3_auto(
        data, convert.from_reference(JaxLtu()), use_all,
        None if cand is None else convert.from_reference(cand), device="cpu")
    assert (got, got_s) == (want, convert.from_reference(want_s))


def test_ties_go_to_the_first_candidate():
    """All-zero blocks: every candidate's rows are equal, so the first wins."""
    data = bytes(16 * 64)
    for cand in (BC3_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES):
        port = convert.from_reference(cand)
        scores = auto.bc3_candidate_scores(_tensor(data), convert.from_reference(
            JaxLtu()), port)
        assert len(set(scores.tolist())) == 1
        _, got_s = auto.transform_bc3_auto(data, convert.from_reference(JaxLtu()),
                                           candidates=port, device="cpu")
        _, want_s = jax_auto.transform_bc3_auto(data, JaxLtu(), candidates=cand)
        assert got_s == port[0] == convert.from_reference(want_s)


@pytest.mark.parametrize("n", [1, 3, 1000, 2048, 4099])
@pytest.mark.parametrize("which", SETS)
def test_regions_match_candidate_regions(which, n):
    """The deduplicated rows, read back per candidate, are JAX's rows."""
    cand = SETS[which]
    key = tuple((int(c.decorrelation_mode), c.split_alpha_endpoints,
                 c.split_colour_endpoints) for c in cand)
    words = np.frombuffer(_data(n, "random"), "<u4")
    flat = lanes.pad_rows(words, 4 * lanes.bucket_size(n))
    want_alpha, want_colour = (np.asarray(r) for r in jax_auto.bc3_candidate_regions(
        flat, jnp.int32(n), key))
    alpha_keys, colour_keys, ai, ci = auto.bc3_keys(convert.from_reference(cand))
    alpha, colour = regions.bc3_regions(_tensor(words.tobytes()), alpha_keys,
                                        colour_keys)
    assert alpha.shape == (len(alpha_keys), 2 * n)
    assert colour.shape == (len(colour_keys), 4 * n)
    np.testing.assert_array_equal(alpha.numpy()[ai], want_alpha[:, :2 * n])
    np.testing.assert_array_equal(colour.numpy()[ci], want_colour[:, :4 * n])


@pytest.mark.parametrize("which", SETS)
def test_regions_match_region_kernel_interpret(which):
    """At n=512 the rows equal the TPU kernel's words: a split alpha row is its
    a0 then its a1 stream, a split colour row its c0w then its c1w stream."""
    n = 512
    words = np.frombuffer(_data(n, "random"), "<u4")
    alpha_keys, colour_keys, _, _ = auto.bc3_keys(convert.from_reference(SETS[which]))
    streams = list(bc3_region_streams_tpu(jnp.asarray(words), alpha_keys, colour_keys,
                                          interpret=True))
    alpha, colour = regions.bc3_regions(_tensor(words.tobytes()), alpha_keys,
                                        colour_keys)
    rows = list(zip(alpha.numpy(), alpha_keys)) + [
        (row, split) for row, (_v, split) in zip(colour.numpy(), colour_keys)]
    for row, split in rows:
        parts = [streams.pop(0) for _ in range(2 if split else 1)]
        assert row.tobytes() == b"".join(np.asarray(p).astype("<u4").tobytes()
                                         for p in parts)
    assert not streams


def test_keys_map_each_candidate_to_its_rows():
    alpha_keys, colour_keys, ai, ci = auto.bc3_keys(
        convert.from_reference(BC3_COMPREHENSIVE_CANDIDATES))
    assert alpha_keys == (True, False) and len(colour_keys) == 8
    for c, a, k in zip(BC3_COMPREHENSIVE_CANDIDATES, ai, ci):
        assert alpha_keys[a] == c.split_alpha_endpoints
        assert colour_keys[k] == (int(c.decorrelation_mode), c.split_colour_endpoints)


@pytest.mark.parametrize("size", range(0, 16))
def test_inputs_shorter_than_a_block_match_jax(size):
    data = bytes(range(size))
    for use_all in (False, True):
        want = jax_auto.transform_bc3_auto(data, JaxLtu(), use_all)
        got = auto.transform_bc3_auto(data, convert.from_reference(JaxLtu()), use_all,
                                      device="cpu")
        assert got == (want[0], convert.from_reference(want[1])) and got[0] == b""


@pytest.mark.parametrize("size", [17, 24, 31, 1000])
def test_longer_unaligned_inputs_raise(size):
    """An auto-transform error; the manual transform keeps its validation error."""
    with pytest.raises(AutoTransformError, match="BC3"):
        auto.transform_bc3_auto(bytes(size), NoEstimation(), device="cpu")
    with pytest.raises(Bc3ValidationError):
        bc3.transform(bytes(size), device="cpu")


def test_no_estimation_picks_the_first_candidate():
    data = _data(100)
    want, want_s = jax_auto.transform_bc3_auto(data, JaxNoEstimation())
    got, got_s = auto.transform_bc3_auto(data, NoEstimation(), device="cpu")
    assert got_s == convert.from_reference(want_s) == convert.from_reference(
        BC3_FAST_CANDIDATES[0])
    assert got == want


def test_estimator_failure_is_an_auto_transform_error():
    class Broken(SizeEstimation):
        def estimate_batch_device(self, regions, valid_len):
            raise OSError("disk on fire")

    with pytest.raises(AutoTransformError, match="BC3"):
        auto.transform_bc3_auto(_data(10), Broken(), device="cpu")
