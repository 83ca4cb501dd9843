"""The four CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device they skip. On a machine with one:

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
from dxt_lossless_transform_tpu_torch.estimate.ltu import DEFAULT_OFFSETS, offset_weight
from dxt_lossless_transform_tpu_torch.ops.cuda import regions, shuffle
from dxt_lossless_transform_tpu_torch.settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, Bc1TransformSettings,
)

pytestmark = pytest.mark.cuda

SETTINGS = list(Bc1TransformSettings.all_combinations())
SIZES = [1, 3, 255, 257, 2048, 100003]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blocks(n, dev):
    data = np.random.default_rng(n).integers(0, 256, 8 * n, np.uint8)
    return torch.from_numpy(data).to(dev)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("s", SETTINGS, ids=str)
def test_shuffle_kernels(cuda, s, n):
    x = _blocks(n, cuda)
    v, sp = int(s.decorrelation_mode), s.split_colour_endpoints
    t = shuffle.bc1_transform(x, v, sp)
    assert torch.equal(t, shuffle.bc1_transform_plain(x, v, sp))
    u = shuffle.bc1_untransform(t, v, sp)
    assert torch.equal(u, shuffle.bc1_untransform_plain(t, v, sp))
    assert torch.equal(u, x)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("cand", [BC1_FAST_CANDIDATES, BC1_COMPREHENSIVE_CANDIDATES],
                         ids=["fast", "comprehensive"])
def test_regions_and_scorer_kernels(cuda, cand, n):
    x = _blocks(n, cuda)
    key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)
    rows = regions.bc1_regions(x, key)
    assert torch.equal(rows, regions.bc1_regions_plain(x, key))
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    for valid in sorted({4 * n, max(0, 4 * n - 7)}):
        assert torch.equal(cuda_ltu.ltu_counts(rows, valid, ks, ws),
                           cuda_ltu.ltu_counts_plain(rows, valid, ks, ws))


@pytest.mark.parametrize("length", [5, 4097, 20000])
def test_scorer_kernel_on_unaligned_rows(cuda, length):
    rng = np.random.default_rng(length)
    rows = torch.from_numpy(rng.integers(0, 3, (3, length), np.uint8)).to(cuda)
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    assert torch.equal(cuda_ltu.ltu_counts(rows, length, ks, ws),
                       cuda_ltu.ltu_counts_plain(rows, length, ks, ws))


def test_each_wrapper_counts_its_launches(cuda):
    x = _blocks(64, cuda)
    backend.reset_launch_counts()
    t = shuffle.bc1_transform(x, 1, True)
    shuffle.bc1_untransform(t, 1, True)
    rows = regions.bc1_regions(x, ((1, True),))
    cuda_ltu.ltu_counts(rows, rows.shape[1], [1], [24])
    torch.cuda.synchronize()
    assert backend.LAUNCHES == {"dlt_bc1_transform": 1, "dlt_bc1_untransform": 1,
                                "dlt_bc1_regions": 1, "dlt_ltu_counts": 1}


def test_wrappers_check_their_inputs(cuda):
    with pytest.raises(ValueError):
        shuffle.bc1_transform(torch.zeros(8, dtype=torch.int32, device=cuda), 0, False)
    with pytest.raises(ValueError):
        shuffle.bc1_transform(torch.zeros(17, dtype=torch.uint8, device=cuda)[1:], 0,
                              False)
    with pytest.raises(ValueError):
        cuda_ltu.ltu_counts(torch.zeros((1, 16), dtype=torch.uint8, device=cuda), 16,
                            [8192], [11])
