"""The port's BC2 auto-search (plain versions, ``device="cpu"``) against the JAX
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
from dxt_lossless_transform_tpu.ops.pallas.regions import bc2_region_streams_tpu
from dxt_lossless_transform_tpu.settings import (
    BC2_COMPREHENSIVE_CANDIDATES, BC2_FAST_CANDIDATES, Bc2TransformSettings,
    YCoCgVariant,
)
from dxt_lossless_transform_tpu.utils.testgen import bc2_realistic
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import AutoTransformError
from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.ops import auto
from dxt_lossless_transform_tpu_torch.ops.cuda import regions

EXPLICIT = (
    Bc2TransformSettings(YCoCgVariant.VARIANT3, True),
    Bc2TransformSettings(YCoCgVariant.NONE, False),
    Bc2TransformSettings(YCoCgVariant.VARIANT2, True),
)
CANDIDATES = {"fast": None, "comprehensive": None, "explicit": EXPLICIT}
SETS = {"fast": BC2_FAST_CANDIDATES, "comprehensive": BC2_COMPREHENSIVE_CANDIDATES,
        "explicit": EXPLICIT}


def _data(n: int, kind: str = "realistic") -> bytes:
    if kind == "realistic":
        return bc2_realistic(n, seed=3)
    return np.random.default_rng(n).integers(0, 256, 16 * n, np.uint8).tobytes()


def _tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _reference_scores(data: bytes, cand) -> list:
    """Each candidate's colour-region score from the JAX package's exact numpy
    twin, over its own (not deduplicated) row."""
    colours = np.frombuffer(data, "<u4").reshape(-1, 4)[:, 2].copy()
    key = [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand]
    return [_coverage_score_np(np.frombuffer(row, np.uint8), DEFAULT_OFFSETS)
            for row in jax_auto._host_colour_regions(colours, key)]


def _port_auto(data, which, estimator=None):
    cand = CANDIDATES[which]
    return auto.transform_bc2_auto(
        data, estimator or convert.from_reference(JaxLtu()), which == "comprehensive",
        None if cand is None else convert.from_reference(cand), device="cpu")


@pytest.mark.parametrize("n", [1, 1000, 40000])
@pytest.mark.parametrize("which", CANDIDATES)
def test_pick_bytes_and_scores_match_jax(which, n):
    data = _data(n)
    want, want_s = jax_auto.transform_bc2_auto(data, JaxLtu(), which == "comprehensive",
                                               CANDIDATES[which])
    got, got_s = _port_auto(data, which)
    assert got_s == convert.from_reference(want_s)
    assert got == want
    scores = auto.bc2_candidate_scores(_tensor(data), convert.from_reference(JaxLtu()),
                                       convert.from_reference(SETS[which]))
    assert scores.dtype == np.int64
    assert scores.tolist() == _reference_scores(data, SETS[which])
    assert SETS[which][int(np.argmin(scores))] == want_s


@pytest.mark.parametrize("which", CANDIDATES)
def test_pick_and_bytes_match_jax_random_blocks(which):
    data = _data(777, "random")
    want, want_s = jax_auto.transform_bc2_auto(data, JaxLtu(), which == "comprehensive",
                                               CANDIDATES[which])
    assert _port_auto(data, which) == (want, convert.from_reference(want_s))


def test_ties_go_to_the_first_candidate():
    """All-zero blocks: every candidate's row is equal, so the first wins."""
    data = bytes(16 * 64)
    for cand in (BC2_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES):
        port = convert.from_reference(cand)
        scores = auto.bc2_candidate_scores(_tensor(data), convert.from_reference(
            JaxLtu()), port)
        assert len(set(scores.tolist())) == 1
        _, got_s = auto.transform_bc2_auto(data, convert.from_reference(JaxLtu()),
                                           candidates=port, device="cpu")
        _, want_s = jax_auto.transform_bc2_auto(data, JaxLtu(), candidates=cand)
        assert got_s == port[0] == convert.from_reference(want_s)


@pytest.mark.parametrize("n", [1, 3, 512, 1000, 4099])
@pytest.mark.parametrize("which", SETS)
def test_regions_match_candidate_regions(which, n):
    """The deduplicated rows, read back per candidate, are JAX's rows cut to 4n."""
    cand = SETS[which]
    key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)
    words = np.frombuffer(_data(n, "random"), "<u4")
    flat = lanes.pad_rows(words, 4 * lanes.bucket_size(n))
    want = np.asarray(jax_auto.bc2_candidate_regions(flat, jnp.int32(n), key))
    keys, index = auto.colour_keys(convert.from_reference(cand))
    rows = regions.bc2_regions(_tensor(words.tobytes()), keys)
    assert rows.shape == (len(keys), 4 * n)
    np.testing.assert_array_equal(rows.numpy()[index], want[:, :4 * n])


@pytest.mark.parametrize("which", SETS)
def test_regions_match_region_kernel_interpret(which):
    """At n=512 the rows equal the TPU kernel's words: a split row is its c0w then
    its c1w stream."""
    n = 512
    words = np.frombuffer(_data(n, "random"), "<u4")
    keys, _ = auto.colour_keys(convert.from_reference(SETS[which]))
    streams = list(bc2_region_streams_tpu(jnp.asarray(words), keys, interpret=True))
    rows = regions.bc2_regions(_tensor(words.tobytes()), keys)
    for row, (_v, split) in zip(rows.numpy(), keys):
        parts = [streams.pop(0) for _ in range(2 if split else 1)]
        assert row.tobytes() == b"".join(np.asarray(p).astype("<u4").tobytes()
                                         for p in parts)
    assert not streams


@pytest.mark.parametrize("size", range(0, 16))
def test_inputs_shorter_than_a_block_match_jax(size):
    data = bytes(range(size))
    for use_all in (False, True):
        want = jax_auto.transform_bc2_auto(data, JaxLtu(), use_all)
        got = auto.transform_bc2_auto(data, convert.from_reference(JaxLtu()), use_all,
                                      device="cpu")
        assert got == (want[0], convert.from_reference(want[1])) and got[0] == b""


@pytest.mark.parametrize("size", [17, 24, 31, 1000])
def test_longer_unaligned_inputs_raise(size):
    with pytest.raises(AutoTransformError, match="BC2"):
        auto.transform_bc2_auto(bytes(size), NoEstimation(), device="cpu")


def test_no_estimation_picks_the_first_candidate():
    data = _data(100)
    want, want_s = jax_auto.transform_bc2_auto(data, JaxNoEstimation())
    got, got_s = auto.transform_bc2_auto(data, NoEstimation(), device="cpu")
    assert got_s == convert.from_reference(want_s) == convert.from_reference(
        BC2_FAST_CANDIDATES[0])
    assert got == want


def test_estimator_failure_is_an_auto_transform_error():
    class Broken(SizeEstimation):
        def estimate_batch_device(self, regions, valid_len):
            raise OSError("disk on fire")

    with pytest.raises(AutoTransformError, match="BC2"):
        auto.transform_bc2_auto(_data(10), Broken(), device="cpu")
