"""The port's BC1 candidate regions (plain version) against the JAX package's
``bc1_candidate_regions`` and the TPU region kernel (interpret mode)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.ops import lanes
from dxt_lossless_transform_tpu.ops.auto import bc1_candidate_regions
from dxt_lossless_transform_tpu.ops.pallas.regions import bc1_region_streams_tpu
from dxt_lossless_transform_tpu.settings import (
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES,
)
from dxt_lossless_transform_tpu_torch.ops.cuda import regions

SETS = {"fast": BC1_FAST_CANDIDATES, "comprehensive": BC1_COMPREHENSIVE_CANDIDATES}


def _key(cand):
    return tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)


def _blocks(n: int) -> np.ndarray:
    words = np.random.default_rng(n).integers(0, 2**32, 2 * n, np.uint64)
    return words.astype("<u4")


@pytest.mark.parametrize("n", [1, 3, 1000, 2048, 4099])
@pytest.mark.parametrize("which", SETS)
def test_rows_match_candidate_regions(which, n):
    key = _key(SETS[which])
    words = _blocks(n)
    flat = lanes.pad_rows(words, 2 * lanes.bucket_size(n))
    want = np.asarray(bc1_candidate_regions(flat, jnp.int32(n), key))[:, :4 * n]
    got = regions.bc1_regions(torch.from_numpy(words.view(np.uint8).copy()), key)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


@pytest.mark.parametrize("which", SETS)
def test_rows_match_region_kernel_interpret(which):
    """At n=2048 the rows equal the TPU kernel's words; a split row is c0w then c1w."""
    n = 2048
    key = _key(SETS[which])
    words = _blocks(n)
    streams = list(bc1_region_streams_tpu(jnp.asarray(words), key, interpret=True))
    got = regions.bc1_regions(torch.from_numpy(words.view(np.uint8).copy()), key)
    for row, (_v, split) in zip(got.numpy(), key):
        parts = [streams.pop(0) for _ in range(2 if split else 1)]
        want = b"".join(np.asarray(p).astype("<u4").tobytes() for p in parts)
        assert row.tobytes() == want


@pytest.mark.parametrize("bad", [(), ((4, True),), tuple(((1, True),) * 9)])
def test_bad_candidates_raise(bad):
    with pytest.raises(ValueError):
        regions.bc1_regions(torch.zeros(16, dtype=torch.uint8), bad)


def test_candidate_code():
    assert regions.candidate_code(((1, True), (0, False), (3, True))) == 0x705
