"""The port's BC1 transform and untransform (plain versions, ``device="cpu"``)
against the JAX package, byte for byte."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.ops import bc1 as jax_bc1
from dxt_lossless_transform_tpu.ops.pallas.shuffle import (
    bc1_transform_tpu, bc1_untransform_tpu,
)
from dxt_lossless_transform_tpu.settings import Bc1TransformSettings as JaxSettings
from dxt_lossless_transform_tpu.utils.testgen import bc1_realistic
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import Bc1ValidationError
from dxt_lossless_transform_tpu_torch.ops import bc1
from dxt_lossless_transform_tpu_torch.ops.cuda import shuffle

SETTINGS = list(JaxSettings.all_combinations())


def _data(n: int, kind: str) -> bytes:
    if kind == "realistic":
        return bc1_realistic(n, seed=n)
    return np.random.default_rng(n).integers(0, 256, 8 * n, np.uint8).tobytes()


@pytest.fixture
def jax_device_path(monkeypatch):
    # every payload through the JAX package's device (XLA) path, not its host path
    monkeypatch.setenv("DLT_DEVICE_MIN_BYTES", "0")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 2048, 4099])
@pytest.mark.parametrize("settings", SETTINGS, ids=str)
def test_matches_jax(settings, n, jax_device_path):
    data = _data(n, "random" if n % 2 else "realistic")
    port = convert.from_reference(settings)
    want = jax_bc1.transform(data, settings)
    got = bc1.transform(data, port, device="cpu")
    assert got == want
    assert bc1.untransform(got, port, device="cpu") == jax_bc1.untransform(want, settings)
    assert bc1.untransform(got, port, device="cpu") == data


@pytest.mark.parametrize("settings", SETTINGS, ids=str)
def test_matches_pallas_kernels_interpret(settings):
    """At n=2048 the streams also equal the TPU kernels' (interpret mode)."""
    n = 2048
    data = _data(n, "random")
    v, split = int(settings.decorrelation_mode), settings.split_colour_endpoints
    streams = bc1_transform_tpu(jnp.asarray(np.frombuffer(data, "<u4")), v, split,
                                interpret=True)
    want = b"".join(np.asarray(s).astype("<u4").tobytes() for s in streams)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = shuffle.bc1_transform(x, v, split)
    assert got.numpy().tobytes() == want
    back = bc1_untransform_tpu(streams, v, split, interpret=True)
    assert np.asarray(back).astype("<u4").tobytes() == data
    assert shuffle.bc1_untransform(got, v, split).numpy().tobytes() == data


@pytest.mark.parametrize("length", [1, 7, 9, 4100])
@pytest.mark.parametrize("fn", [bc1.transform, bc1.untransform])
def test_wrong_length_raises(fn, length):
    with pytest.raises(Bc1ValidationError):
        fn(bytes(length), device="cpu")


@pytest.mark.parametrize("fn", [bc1.transform, bc1.untransform])
def test_empty(fn):
    assert fn(b"", device="cpu") == b""


def test_bit31_colour_words():
    """Colour words with c1's top bit set survive every setting."""
    words = np.full((64, 2), 0xFFFF8000, dtype="<u4")
    words[::2, 0] = 0x80017FFF
    data = words.tobytes()
    for s in SETTINGS:
        port = convert.from_reference(s)
        out = bc1.transform(data, port, device="cpu")
        assert out == jax_bc1.transform(data, s)
        assert bc1.untransform(out, port, device="cpu") == data
