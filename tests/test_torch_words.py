"""The port's word deinterleave (``ops/cuda/planes.py:deinterleave_words``, plain
version on the CPU) and its lane helpers (``ops/lanes.py``) against the JAX package:
its Pallas ``deinterleave_words_tpu`` in interpret mode where its tile grid takes the
shape (k·N % 2048 == 0), its XLA ``lanes.deinterleave`` at every other N. Inputs are
random words from numpy; the streams must be equal word for word (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.ops import lanes as jax_lanes
from dxt_lossless_transform_tpu.ops.pallas.planes import deinterleave_words_tpu
from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.ops import lanes
from dxt_lossless_transform_tpu_torch.ops.cuda import planes

# N words per stream: the Pallas kernel's shapes (k·N a multiple of 2048), and
# shapes only the port's kernel takes (the TPU path fell back to XLA there)
TILED = {2: [1024, 3072], 4: [512, 2048]}
UNTILED = [1, 2, 3, 5, 1000, 4095, 4097]


def _words(count: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, count, dtype=np.uint32)


def _port(flat: np.ndarray, k: int) -> list:
    streams = planes.deinterleave_words(torch.from_numpy(flat.view(np.int32)), k)
    return [s.numpy().view(np.uint32) for s in streams]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("tile", [0, 1])
def test_deinterleave_matches_pallas_interpret(k, tile):
    n = TILED[k][tile]
    flat = _words(k * n, 10 * k + tile)
    want = deinterleave_words_tpu(jnp.asarray(flat), k, interpret=True)
    got = _port(flat, k)
    assert len(got) == k
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("n", UNTILED)
def test_deinterleave_matches_lanes_at_any_n(k, n):
    flat = _words(k * n, n + k)
    want = jax_lanes.deinterleave(jnp.asarray(flat), k)
    got = _port(flat, k)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, flat[i::k])


def test_deinterleave_streams_are_rows_and_cpu_takes_the_plain_version():
    backend.reset_launch_counts()
    flat = torch.from_numpy(_words(4 * 777, 3).view(np.int32))
    streams = planes.deinterleave_words(flat, 4)
    for s, p in zip(streams, planes.deinterleave_words_plain(flat, 4)):
        assert s.is_contiguous() and torch.equal(s, p)
    assert backend.LAUNCHES["dlt_deinterleave_words"] == 0
    empty = planes.deinterleave_words(torch.empty(0, dtype=torch.int32), 2)
    assert [s.numel() for s in empty] == [0, 0]


@pytest.mark.parametrize("bad", [
    dict(k=3, x=torch.zeros(6, dtype=torch.int32)),
    dict(k=2, x=torch.zeros(6, dtype=torch.uint8)),
    dict(k=4, x=torch.zeros(6, dtype=torch.int32)),
    dict(k=2, x=torch.zeros((2, 2), dtype=torch.int32)),
], ids=["k3", "uint8", "not-k-words", "2-d"])
def test_deinterleave_rejects(bad):
    with pytest.raises(ValueError):
        planes.deinterleave_words(bad["x"], bad["k"])


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 4096, 100_000, 349_527])
def test_bucket_size_matches_jax(n):
    assert lanes.MIN_BUCKET == jax_lanes.MIN_BUCKET
    assert lanes.bucket_size(n) == jax_lanes.bucket_size(n)


@pytest.mark.parametrize("k", [2, 4])
def test_lanes_deinterleave_and_split_match_jax(k):
    flat = _words(k * 2048, 40 + k)
    want = jax_lanes.deinterleave(jnp.asarray(flat), k)
    got = lanes.deinterleave(torch.from_numpy(flat.view(np.int32)), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
        lo, hi = lanes.split_u32(g)
        jlo, jhi = jax_lanes.split_u32(w)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
