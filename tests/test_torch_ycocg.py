"""The port's YCoCg-R (plain PyTorch) against the JAX package's numpy oracle and
SWAR pair forms, on every 16-bit input and on colour words with bit 31 set."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.ops import ycocg as jax_ycocg
from dxt_lossless_transform_tpu.oracle import ycocg as oracle
from dxt_lossless_transform_tpu_torch.ops import ycocg

ALL16 = np.arange(65536, dtype=np.int64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64).astype(np.int32))


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_decorrelate_all_inputs(variant):
    got = ycocg.decorrelate(_t(ALL16), variant).numpy()
    np.testing.assert_array_equal(got, oracle.decorrelate(ALL16, variant))


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_recorrelate_all_inputs(variant):
    got = ycocg.recorrelate(_t(ALL16), variant).numpy()
    np.testing.assert_array_equal(got, oracle.recorrelate(ALL16, variant))


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_round_trip_all_inputs(variant):
    c = _t(ALL16)
    assert torch.equal(ycocg.recorrelate(ycocg.decorrelate(c, variant), variant), c)


def _words():
    rng = np.random.default_rng(11)
    w = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:16] |= np.uint32(0x80000000)  # bit 31 is c1's top bit
    w[16:24] = [0xFFFFFFFF, 0x80000000, 0x8000FFFF, 0xFFFF0000, 0, 0x7FFFFFFF,
                0x80008000, 0xFFFF8000]
    return w


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
@pytest.mark.parametrize("direction", ["decorrelate", "recorrelate"])
def test_pairs_match_swar(variant, direction):
    w = _words()
    port = getattr(ycocg, f"{direction}_pair")
    ref = getattr(jax_ycocg, f"{direction}_pair_swar")
    got = port(torch.from_numpy(w.view(np.int32)), variant).numpy().view(np.uint32)
    want = np.asarray(ref(jnp.asarray(w), variant))
    np.testing.assert_array_equal(got, want)
