"""Four faults of the port's BC1 and BC3 paths, repaired, each held to the JAX
package (or, for the error of an unaligned input, to the port's own contract):

1. a candidate list with repeats (more than 8 candidates) picks as JAX does;
2. an estimator that defines only ``estimate`` scores on the host and picks as
   JAX does;
3. an auto-search input of at least one block whose length is not a whole number
   of blocks raises ``AutoTransformError``;
4. the count kernel's wrapper takes more than 65,535 rows.
"""

import zlib

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.estimate.base import SizeEstimation as JaxSizeEstimation
from dxt_lossless_transform_tpu.estimate.ltu import (
    DEFAULT_OFFSETS, LtuEstimation as JaxLtu, _coverage_score_np,
)
from dxt_lossless_transform_tpu.ops import auto as jax_auto, bc45 as jax_bc45
from dxt_lossless_transform_tpu.settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
    BC3_COMPREHENSIVE_CANDIDATES,
)
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import backend, convert
from dxt_lossless_transform_tpu_torch.errors import (
    AutoTransformError, Bc1ValidationError, Bc2ValidationError, Bc3ValidationError,
)
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.estimate.ltu import DEFAULT_OFFSETS as OFFSETS
from dxt_lossless_transform_tpu_torch.estimate.ltu import offset_weight
from dxt_lossless_transform_tpu_torch.ops import auto, bc1, bc2, bc3, bc45

# format -> (block size, JAX search, port search, port scores, realistic data)
SEARCHES = {
    "BC1": (8, jax_auto.transform_bc1_auto, auto.transform_bc1_auto,
            auto.candidate_scores, jax_testgen.bc1_realistic),
    "BC2": (16, jax_auto.transform_bc2_auto, auto.transform_bc2_auto,
            auto.bc2_candidate_scores, jax_testgen.bc2_realistic),
    "BC3": (16, jax_auto.transform_bc3_auto, auto.transform_bc3_auto,
            auto.bc3_candidate_scores, jax_testgen.bc3_realistic),
}
COMPREHENSIVE = {"BC1": BC1_COMPREHENSIVE_CANDIDATES, "BC2": BC2_COMPREHENSIVE_CANDIDATES,
                 "BC3": BC3_COMPREHENSIVE_CANDIDATES}


def _tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _exact(row: bytes) -> int:
    return _coverage_score_np(np.frombuffer(row, np.uint8), DEFAULT_OFFSETS)


def _reference_scores(fmt: str, data: bytes, cand) -> list:
    """Each candidate's score over its own rows, from the JAX numpy twin."""
    words = np.frombuffer(data, "<u4").reshape(-1, 2 if fmt == "BC1" else 4)
    colours = words[:, 0 if fmt == "BC1" else 2].copy()
    key = [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand]
    scores = [_exact(row) for row in jax_auto._host_colour_regions(colours, key)]
    if fmt == "BC3":
        ep = (words[:, 0] & 0xFFFF).astype(np.int64)
        alpha = {False: _exact(ep.astype("<u2").tobytes()),
                 True: _exact((ep & 0xFF).astype(np.uint8).tobytes()
                              + (ep >> 8).astype(np.uint8).tobytes())}
        scores = [s + alpha[c.split_alpha_endpoints] for s, c in zip(scores, cand)]
    return scores


# ---- 1. repeated candidates ------------------------------------------------------

@pytest.mark.parametrize("repeat", [0, 3, -1])
@pytest.mark.parametrize("fmt", SEARCHES)
def test_repeated_candidates_pick_as_jax(fmt, repeat):
    """COMPREHENSIVE plus one repeated candidate: the JAX pick and bytes, and every
    candidate's score equal to the exact twin's over its own rows."""
    _, jax_search, port_search, port_scores, realistic = SEARCHES[fmt]
    data = realistic(3000, 11)
    cand = COMPREHENSIVE[fmt] + (COMPREHENSIVE[fmt][repeat],)
    want, want_s = jax_search(data, JaxLtu(), candidates=cand)
    got, got_s = port_search(data, convert.from_reference(JaxLtu()),
                             candidates=convert.from_reference(cand), device="cpu")
    assert (got, got_s) == (want, convert.from_reference(want_s))
    scores = port_scores(_tensor(data), convert.from_reference(JaxLtu()),
                         convert.from_reference(cand))
    assert scores.tolist() == _reference_scores(fmt, data, cand)


def test_all_candidates_twice():
    """Sixteen BC1 candidates, each twice, still build only 8 rows."""
    cand = convert.from_reference(BC1_COMPREHENSIVE_CANDIDATES * 2)
    keys, index = auto.colour_keys(cand)
    assert len(keys) == 8 and index == list(range(8)) * 2
    data = jax_testgen.bc1_realistic(500, 2)
    want = jax_auto.transform_bc1_auto(data, JaxLtu(),
                                       candidates=BC1_COMPREHENSIVE_CANDIDATES * 2)
    got = auto.transform_bc1_auto(data, convert.from_reference(JaxLtu()),
                                  candidates=cand, device="cpu")
    assert got == (want[0], convert.from_reference(want[1]))


# ---- 2. host-only estimators -------------------------------------------------------

class _Zlib:
    """An estimator that defines only ``estimate``: zlib's size at level 6."""

    def estimate(self, data) -> int:
        return len(zlib.compress(bytes(data), 6))


class JaxZlib(_Zlib, JaxSizeEstimation):
    pass


class PortZlib(_Zlib, SizeEstimation):
    pass


@pytest.mark.parametrize("use_all", [False, True])
@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("fmt", SEARCHES)
def test_host_only_estimator_picks_as_jax(fmt, kind, use_all):
    bs, jax_search, port_search, _, realistic = SEARCHES[fmt]
    data = (realistic(2000, 5) if kind == "realistic"
            else np.random.default_rng(9).integers(0, 256, bs * 2000, np.uint8).tobytes())
    want, want_s = jax_search(data, JaxZlib(), use_all)
    got, got_s = port_search(data, PortZlib(), use_all, device="cpu")
    assert (got, got_s) == (want, convert.from_reference(want_s))


@pytest.mark.parametrize("fmt", ["BC4", "BC5"])
def test_host_only_estimator_picks_as_jax_bc45(fmt):
    bs = 8 if fmt == "BC4" else 16
    jax_search = jax_bc45.transform_bc4_auto if fmt == "BC4" else jax_bc45.transform_bc5_auto
    port_search = bc45.transform_bc4_auto if fmt == "BC4" else bc45.transform_bc5_auto
    for seed in range(4):
        rng = np.random.default_rng(seed)
        sections = rng.integers(0, 256, (300 * bs // 8, 8), np.uint8)
        sections[:, 0] = np.arange(len(sections)) // (seed + 1)
        data = sections.tobytes()
        want, want_s = jax_search(data, JaxZlib())
        got, got_s = port_search(data, PortZlib(), device="cpu")
        assert (got, got_s) == (want, convert.from_reference(want_s))


def test_host_only_estimator_scores_rows_on_the_host():
    est = PortZlib()
    rows = _tensor(bytes(range(256)) * 3).view(3, 256)
    scores = est.estimate_batch_device(rows, 200)
    assert scores.dtype == torch.int64 and scores.device == rows.device
    assert scores.tolist() == [est.estimate(bytes(r[:200].tolist())) for r in rows]
    assert est.estimate_batch([b"a", b"bb"]) == [est.estimate(b"a"), est.estimate(b"bb")]
    with pytest.raises(NotImplementedError):
        est.max_compressed_size(10)
    assert NoEstimation().max_compressed_size(10) == 0


def test_fractional_host_scores_keep_their_order():
    """Scores that are not integers are compared as they are, not truncated."""
    class Halves(SizeEstimation):
        def estimate(self, data):
            return 10.5 if data[0] else 10.25

    rows = torch.tensor([[1, 0], [0, 0]], dtype=torch.uint8)
    scores = Halves().estimate_batch_device(rows, 2)
    assert scores.dtype == torch.float64 and scores.tolist() == [10.5, 10.25]
    assert auto.score("BC1", Halves(), rows, 2).tolist() == [10.5, 10.25]


# ---- 3. unaligned inputs to the auto-search -----------------------------------------

@pytest.mark.parametrize("blocks,extra", [(1, 1), (300, 3), (2, 7)])
@pytest.mark.parametrize("fmt", SEARCHES)
def test_unaligned_auto_input_is_an_auto_transform_error(fmt, blocks, extra):
    bs, _, port_search, _, _ = SEARCHES[fmt]
    data = bytes(blocks * bs + extra)
    with pytest.raises(AutoTransformError, match=fmt):
        port_search(data, convert.from_reference(JaxLtu()), device="cpu")


@pytest.mark.parametrize("fn,error,size", [
    (bc1.transform, Bc1ValidationError, 2403), (bc1.untransform, Bc1ValidationError, 9),
    (bc2.transform, Bc2ValidationError, 4803), (bc2.untransform, Bc2ValidationError, 17),
    (bc3.transform, Bc3ValidationError, 4803), (bc3.untransform, Bc3ValidationError, 17)])
def test_manual_transforms_keep_their_validation_errors(fn, error, size):
    with pytest.raises(error):
        fn(bytes(size), device="cpu")


# ---- 4. any number of count rows ---------------------------------------------------

ROWS = 70_000


def _short_rows() -> torch.Tensor:
    rng = np.random.default_rng(4)
    return torch.from_numpy(rng.integers(0, 3, (ROWS, 12), np.uint8))


def test_counts_of_many_rows_equal_row_by_row():
    rows = _short_rows()
    ks = list(OFFSETS)
    ws = [offset_weight(k) for k in ks]
    counts = cuda_ltu.ltu_counts(rows, 12, ks, ws)
    assert counts.shape == (ROWS,)
    picks = list(range(0, ROWS, 997)) + [65534, 65535, 65536, ROWS - 1]
    for r in picks:
        assert int(counts[r]) == int(cuda_ltu.ltu_counts(rows[r:r + 1], 12, ks, ws)[0])
    want = [_coverage_score_np(rows[r].numpy(), DEFAULT_OFFSETS) for r in picks]
    from dxt_lossless_transform_tpu_torch.estimate.ltu import coverage_scores
    assert coverage_scores(rows[picks], 12).tolist() == want


def test_count_wrapper_hands_every_row_to_the_kernel(monkeypatch):
    """On a CUDA tensor the wrapper passes all 70,000 rows to the one entry point,
    which launches the kernel once per 65,535 rows; it used to raise."""
    calls = []
    monkeypatch.setattr(backend, "dispatch", lambda t: True)
    monkeypatch.setattr(backend, "require_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(backend, "launch", lambda name, dev, *args: calls.append(
        (name, args)))
    rows = _short_rows()
    cuda_ltu.ltu_counts(rows, 12, list(OFFSETS), [offset_weight(k) for k in OFFSETS])
    [(name, args)] = calls
    assert name == "dlt_ltu_counts"
    assert args[0] == rows.data_ptr() and args[2:5] == (ROWS, 12, 12)
