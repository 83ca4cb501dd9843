"""The port's BC1 auto-search (plain versions, ``device="cpu"``) picks the same
settings and writes the same bytes as the JAX package's ``transform_bc1_auto``."""

import numpy as np
import pytest

from dxt_lossless_transform_tpu.estimate.base import NoEstimation as JaxNoEstimation
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.ops import auto as jax_auto
from dxt_lossless_transform_tpu.settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, Bc1TransformSettings,
    YCoCgVariant,
)
from dxt_lossless_transform_tpu.utils.testgen import bc1_realistic
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import AutoTransformError, Bc1ValidationError
from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.ops import auto, bc1

EXPLICIT = (
    Bc1TransformSettings(YCoCgVariant.VARIANT3, True),
    Bc1TransformSettings(YCoCgVariant.NONE, False),
    Bc1TransformSettings(YCoCgVariant.VARIANT2, True),
)
CANDIDATES = {"fast": None, "comprehensive": None, "explicit": EXPLICIT}


def _data(n: int, kind: str) -> bytes:
    if kind == "realistic":
        return bc1_realistic(n, seed=3)
    return np.random.default_rng(n).integers(0, 256, 8 * n, np.uint8).tobytes()


def _assert_same(data, which):
    use_all = which == "comprehensive"
    cand = CANDIDATES[which]
    want, want_s = jax_auto.transform_bc1_auto(data, JaxLtu(), use_all, cand)
    got, got_s = auto.transform_bc1_auto(
        data, convert.from_reference(JaxLtu()), use_all,
        None if cand is None else convert.from_reference(cand), device="cpu")
    assert got_s == convert.from_reference(want_s)
    assert got == want


@pytest.mark.parametrize("n", [1, 1000, 40000])
@pytest.mark.parametrize("which", CANDIDATES)
def test_pick_and_bytes_match_jax(which, n):
    _assert_same(_data(n, "realistic"), which)


@pytest.mark.parametrize("which", CANDIDATES)
def test_pick_and_bytes_match_jax_random_blocks(which):
    _assert_same(_data(777, "random"), which)


def test_scores_are_the_candidate_order_of_jax():
    """candidate_scores gives one exact score per candidate, in candidate order."""
    import torch

    data = _data(3000, "realistic")
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    cand = convert.from_reference(BC1_COMPREHENSIVE_CANDIDATES)
    scores = auto.candidate_scores(x, convert.from_reference(JaxLtu()), cand)
    colours = np.frombuffer(data, "<u4").reshape(-1, 2)[:, 0].copy()
    key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints)
                for c in BC1_COMPREHENSIVE_CANDIDATES)
    rows = jax_auto._host_colour_regions(colours, key)
    assert list(scores) == [JaxLtu().estimate(r) for r in rows]


def test_no_estimation_picks_the_first_candidate():
    data = _data(100, "realistic")
    want, want_s = jax_auto.transform_bc1_auto(data, JaxNoEstimation())
    got, got_s = auto.transform_bc1_auto(data, NoEstimation(), device="cpu")
    assert got_s == convert.from_reference(want_s) == convert.from_reference(
        BC1_FAST_CANDIDATES[0])
    assert got == want


def test_no_estimation_scores_where_the_regions_lie():
    import torch

    regions = torch.zeros((3, 40), dtype=torch.uint8)
    scores = NoEstimation().estimate_batch_device(regions, 40)
    assert scores.device == regions.device and scores.tolist() == [0, 0, 0]


def test_estimator_failure_is_an_auto_transform_error():
    class Broken(SizeEstimation):
        def estimate_batch_device(self, regions, valid_len):
            raise OSError("disk on fire")

    with pytest.raises(AutoTransformError):
        auto.transform_bc1_auto(_data(10, "realistic"), Broken(), device="cpu")


def test_empty_and_bad_lengths():
    """An unaligned input of at least one block is an auto-transform error; the
    manual transform keeps its validation error."""
    out, s = auto.transform_bc1_auto(b"", NoEstimation(), device="cpu")
    assert out == b"" and s == convert.from_reference(BC1_FAST_CANDIDATES[-1])
    with pytest.raises(AutoTransformError):
        auto.transform_bc1_auto(bytes(12), NoEstimation(), device="cpu")
    with pytest.raises(AutoTransformError):
        auto.transform_bc1_auto(bytes(9), NoEstimation(), device="cpu")
    with pytest.raises(Bc1ValidationError):
        bc1.transform(bytes(12), device="cpu")


@pytest.mark.parametrize("size", range(0, 8))
def test_inputs_shorter_than_a_block_match_jax(size):
    """1-7 bytes give empty output and the last candidate, as in the JAX package."""
    data = bytes(range(size))
    for use_all in (False, True):
        want = jax_auto.transform_bc1_auto(data, JaxLtu(), use_all)
        got = auto.transform_bc1_auto(data, convert.from_reference(JaxLtu()), use_all,
                                      device="cpu")
        assert got == (want[0], convert.from_reference(want[1])) and got[0] == b""
