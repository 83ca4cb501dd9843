"""Host-only scoring of device rows (``estimate/base.py``) and the BC3 per-file search
that feeds it (``ops/auto.bc3_candidate_scores``), on the CPU: the rows are read in
place and all of a search's rows go to the estimator in one submission, with the
scores, picks and bytes of the former path (each row copied out with ``tobytes``,
alpha rows and colour rows scored apart)."""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation
from dxt_lossless_transform_tpu_torch.ops import auto, bc3
from dxt_lossless_transform_tpu_torch.ops.cuda import regions
from dxt_lossless_transform_tpu_torch.settings import (
    BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES, Bc3TransformSettings,
    YCoCgVariant,
)
from dxt_lossless_transform_tpu_torch.utils import testgen

SETS = {"fast": BC3_FAST_CANDIDATES, "comprehensive": BC3_COMPREHENSIVE_CANDIDATES,
        "explicit": (Bc3TransformSettings(YCoCgVariant.VARIANT3, False, True),
                     Bc3TransformSettings(YCoCgVariant.NONE, True, False),
                     Bc3TransformSettings(YCoCgVariant.VARIANT3, True, True))}


class _Recording(SizeEstimation):
    """A host estimator that records each submission's buffers: the zstd-1 size of
    each."""

    def __init__(self):
        self.calls = []
        self.zstd = ZstdEstimation(1)

    def estimate(self, data) -> int:
        return self.zstd.estimate(data)

    def estimate_batch(self, regions):
        self.calls.append([bytes(r) for r in regions])
        return self.zstd.estimate_batch(regions)


def _rows(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.integers(0, 8, (5, 40), np.uint8), 50, axis=1)
    rows = torch.from_numpy(runs ^ (rng.random(runs.shape) < 0.05).astype(np.uint8))
    return rows, torch.tensor([2000, 1999, 17, 0, 1000])


def _per_row_tobytes(est, rows, lengths) -> list:
    """The former path: each row's real bytes copied out, then scored."""
    host = rows.cpu().numpy()
    return est.estimate_batch([host[r, :v].tobytes() for r, v in enumerate(lengths)])


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_scores_of_device_rows_are_those_of_per_row_copies(seed, level):
    est = ZstdEstimation(level)
    rows, valid = _rows(seed)
    got = est.estimate_batch_device(rows, valid)
    assert got.dtype == torch.int64 and got.device == rows.device
    assert got.tolist() == _per_row_tobytes(est, rows, valid.tolist())
    assert est.estimate_batch_device(rows, 1500).tolist() == \
        _per_row_tobytes(est, rows, [1500] * 5)


@pytest.mark.parametrize("est", ["recording", "ltu", "none"])
def test_parts_score_as_their_separate_calls(est):
    est = {"recording": _Recording, "ltu": LtuEstimation, "none": NoEstimation}[est]()
    rows, valid = _rows(3)
    parts = [(rows[:2], valid[:2]), (rows[2:], 40), (rows[:0], 7)]
    got = est.estimate_parts_device(parts)
    want = [est.estimate_batch_device(r, v) for r, v in parts]
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    if isinstance(est, _Recording):
        # a host estimator: one submission for all parts, then one a part
        assert [len(c) for c in est.calls] == [5, 2, 3, 0]


@pytest.mark.parametrize("name", sorted(SETS))
def test_the_bc3_search_submits_every_row_at_once(name):
    cand = SETS[name]
    x = torch.frombuffer(bytearray(testgen.bc3_realistic(700, seed=4)), dtype=torch.uint8)
    alpha_keys, colour_keys, _, _ = auto.bc3_keys(cand)
    est = _Recording()
    auto.bc3_candidate_scores(x, est, cand)
    assert len(est.calls) == 1
    assert [len(b) for b in est.calls[0]] == \
        [2 * 700] * len(alpha_keys) + [4 * 700] * len(colour_keys)


def _former_pick(data: bytes, cand) -> Bc3TransformSettings:
    """The former search: alpha rows scored, then colour rows, each row a copy."""
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    alpha_keys, colour_keys, ai, ci = auto.bc3_keys(cand)
    alpha, colour = regions.bc3_regions(x, alpha_keys, colour_keys)
    est = ZstdEstimation(1)
    n = len(data) // 16
    a = np.asarray(_per_row_tobytes(est, alpha, [2 * n] * len(alpha_keys)))
    c = np.asarray(_per_row_tobytes(est, colour, [4 * n] * len(colour_keys)))
    return cand[int(np.argmin(a[ai] + c[ci]))]


@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_bc3_picks_and_bytes_under_zstd1_are_unchanged(name, kind):
    cand = SETS[name]
    data = (testgen.bc3_realistic(900, seed=7) if kind == "realistic" else
            np.random.default_rng(9).integers(0, 256, 16 * 900, np.uint8).tobytes())
    out, best = auto.transform_bc3_auto(data, ZstdEstimation(1), candidates=cand,
                                        device="cpu")
    want = _former_pick(data, cand)
    assert best == want
    assert out == bc3.transform(data, want, device="cpu")
