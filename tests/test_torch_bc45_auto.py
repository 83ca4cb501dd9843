"""The port's BC4 and BC5 auto-searches (plain versions, ``device="cpu"``) against
the JAX package: exact integer scores of each candidate's endpoint streams, picks
and bytes."""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.estimate.base import NoEstimation as JaxNoEstimation
from dxt_lossless_transform_tpu.estimate.ltu import (
    DEFAULT_OFFSETS, LtuEstimation as JaxLtu, _coverage_score_np,
)
from dxt_lossless_transform_tpu.ops import bc45 as jax_bc45
from dxt_lossless_transform_tpu.oracle.bc4 import _ep_streams
from dxt_lossless_transform_tpu.settings import (
    Bc4TransformSettings as Jax4, Bc5TransformSettings as Jax5,
)
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import AutoTransformError
from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.ops import bc45
from dxt_lossless_transform_tpu_torch.ops.cuda import shuffle

# format -> (block size, endpoint bytes per block, JAX search, port search, port
# kernel wrapper, JAX settings class)
FORMATS = {
    "BC4": (8, 2, jax_bc45.transform_bc4_auto, bc45.transform_bc4_auto,
            shuffle.bc4_transform, Jax4),
    "BC5": (16, 4, jax_bc45.transform_bc5_auto, bc45.transform_bc5_auto,
            shuffle.bc5_transform, Jax5),
}
CANDIDATE_SETS = {"default": None, "false-first": (False, True), "true-only": (True,),
                  "repeated": (False, True, False, True)}


def _data(n: int, block_size: int, kind: str) -> bytes:
    rng = np.random.default_rng(n + block_size)
    if kind == "random":
        return rng.integers(0, 256, block_size * n, np.uint8).tobytes()
    # slowly varying endpoints: the split layout wins on some, not on others
    sections = rng.integers(0, 256, (n * block_size // 8, 8), np.uint8)
    t = np.arange(len(sections))
    sections[:, 0] = (t // 7) & 0xFF
    sections[:, 1] = (t // 3 + rng.integers(0, 2, len(sections))) & 0xFF
    return sections.tobytes()


def _reference_scores(fmt: str, data: bytes, cand) -> list:
    """Each candidate's endpoint-stream score from the JAX package's exact numpy
    twin, over the rows that JAX's search builds."""
    halves = np.frombuffer(data, "<u2").reshape(-1, 4)
    eps = [halves[:, 0].copy()] if fmt == "BC4" else [halves[0::2, 0].copy(),
                                                      halves[1::2, 0].copy()]
    return [_coverage_score_np(np.frombuffer(
        b"".join(_ep_streams(ep, c.split_endpoints) for ep in eps), np.uint8),
        DEFAULT_OFFSETS) for c in cand]


def _candidates(fmt: str, which: str):
    splits = CANDIDATE_SETS[which]
    cls = FORMATS[fmt][5]
    return None if splits is None else tuple(cls(s) for s in splits)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 40001])
@pytest.mark.parametrize("kind", ["structured", "random"])
@pytest.mark.parametrize("which", CANDIDATE_SETS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_pick_bytes_and_scores_match_jax(fmt, which, kind, n):
    bs, ep_bytes, jax_auto, port_auto, kernel, cls = FORMATS[fmt]
    data = _data(n, bs, kind)
    cand = _candidates(fmt, which)
    want, want_s = jax_auto(data, JaxLtu(), False, cand)
    got, got_s = port_auto(data, convert.from_reference(JaxLtu()), False,
                           None if cand is None else convert.from_reference(cand),
                           device="cpu")
    assert got_s == convert.from_reference(want_s)
    assert got == want
    full = cand if cand is not None else tuple(cls.all_combinations())
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    scores, _ = bc45.endpoint_scores(fmt, x, LtuEstimation(),
                                     convert.from_reference(full), ep_bytes * n, kernel)
    assert scores.dtype == np.int64
    assert scores.tolist() == _reference_scores(fmt, data, full)
    assert full[int(np.argmin(scores))] == want_s


@pytest.mark.parametrize("fmt", FORMATS)
def test_both_layouts_win_somewhere(fmt):
    """The cases above exercise both picks: the split layout wins on one input and
    the interleaved layout on another."""
    bs, _, jax_auto, *_ = FORMATS[fmt]
    picks = {jax_auto(_data(n, bs, kind), JaxLtu())[1].split_endpoints
             for n in (1000, 40001) for kind in ("structured", "random")}
    assert picks == {True, False}


@pytest.mark.parametrize("fmt,size", [(fmt, size) for fmt, spec in FORMATS.items()
                                       for size in range(spec[0])])
def test_inputs_shorter_than_a_block_match_jax(fmt, size):
    _, _, jax_auto, port_auto, _, _ = FORMATS[fmt]
    data = bytes(range(size))
    want = jax_auto(data, JaxLtu())
    got = port_auto(data, LtuEstimation(), device="cpu")
    assert got == (want[0], convert.from_reference(want[1])) and got[0] == b""


@pytest.mark.parametrize("blocks,extra", [(1, 1), (1, 7), (2, 3), (125, 1)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_longer_unaligned_inputs_raise(fmt, blocks, extra):
    bs, _, _, port_auto, _, _ = FORMATS[fmt]
    size = blocks * bs + extra
    with pytest.raises(AutoTransformError, match=fmt):
        port_auto(bytes(size), NoEstimation(), device="cpu")


@pytest.mark.parametrize("fmt", FORMATS)
def test_no_estimation_picks_the_first_candidate(fmt):
    bs, _, jax_auto, port_auto, _, cls = FORMATS[fmt]
    data = _data(100, bs, "random")
    want, want_s = jax_auto(data, JaxNoEstimation())
    got, got_s = port_auto(data, NoEstimation(), device="cpu")
    assert got_s == convert.from_reference(want_s) == convert.from_reference(cls(True))
    assert got == want


@pytest.mark.parametrize("fmt", FORMATS)
def test_estimator_failure_is_an_auto_transform_error(fmt):
    bs, _, _, port_auto, _, _ = FORMATS[fmt]

    class Broken(SizeEstimation):
        def estimate_batch_device(self, regions, valid_len):
            raise OSError("disk on fire")

    with pytest.raises(AutoTransformError, match=fmt):
        port_auto(_data(10, bs, "random"), Broken(), device="cpu")
