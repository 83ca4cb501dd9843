"""The port's BC2 transform and untransform (plain versions, ``device="cpu"``)
against the JAX package, byte for byte."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.ops import bc2 as jax_bc2
from dxt_lossless_transform_tpu.ops.pallas.shuffle import (
    bc2_transform_tpu, bc2_untransform_tpu,
)
from dxt_lossless_transform_tpu.settings import Bc2TransformSettings as JaxSettings
from dxt_lossless_transform_tpu.utils.testgen import bc2_realistic
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import Bc2ValidationError
from dxt_lossless_transform_tpu_torch.ops import bc2
from dxt_lossless_transform_tpu_torch.ops.cuda import shuffle

SETTINGS = list(JaxSettings.all_combinations())


def _data(n: int, kind: str) -> bytes:
    if kind == "realistic":
        return bc2_realistic(n, seed=n)
    return np.random.default_rng(n).integers(0, 256, 16 * n, np.uint8).tobytes()


# 70,000 blocks (1.12 MB) is above the JAX package's 1 MiB device threshold, so
# there it takes its device path; below, its host path.
@pytest.mark.parametrize("n", [1, 2, 3, 5, 2047, 2049, 70000])
@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("settings", SETTINGS, ids=str)
def test_matches_jax(settings, kind, n):
    data = _data(n, kind)
    port = convert.from_reference(settings)
    want = jax_bc2.transform(data, settings)
    got = bc2.transform(data, port, device="cpu")
    assert got == want
    assert bc2.untransform(got, port, device="cpu") == data
    assert jax_bc2.untransform(got, settings) == data


@pytest.mark.parametrize("settings", SETTINGS, ids=str)
def test_matches_pallas_kernels_interpret(settings):
    """At n=2048 the streams also equal the TPU kernels' (interpret mode)."""
    n = 2048
    data = _data(n, "random")
    args = (int(settings.decorrelation_mode), settings.split_colour_endpoints)
    streams = bc2_transform_tpu(jnp.asarray(np.frombuffer(data, "<u4")), *args,
                                interpret=True)
    want = b"".join(np.asarray(s).astype("<u4").tobytes() for s in streams)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = shuffle.bc2_transform(x, *args)
    assert got.numpy().tobytes() == want
    back = bc2_untransform_tpu(streams, *args, interpret=True)
    assert np.asarray(back).astype("<u4").tobytes() == data
    assert shuffle.bc2_untransform(got, *args).numpy().tobytes() == data


@pytest.mark.parametrize("length", [1, 8, 15, 17, 4100])
@pytest.mark.parametrize("fn", [bc2.transform, bc2.untransform])
def test_wrong_length_raises(fn, length):
    with pytest.raises(Bc2ValidationError):
        fn(bytes(length), device="cpu")


@pytest.mark.parametrize("fn", [bc2.transform, bc2.untransform])
def test_empty(fn):
    assert fn(b"", device="cpu") == b""


def test_bit31_colour_words_and_extreme_alpha():
    """Colour words with c1's top bit set, and alpha bytes 0 and 255, survive every
    setting."""
    words = np.full((65, 4), 0xFFFF8000, dtype="<u4")
    words[::2, :2] = 0
    words[1::2, :2] = 0xFFFFFFFF
    words[::3, 2] = 0x80017FFF
    data = words.tobytes()
    for s in SETTINGS:
        port = convert.from_reference(s)
        out = bc2.transform(data, port, device="cpu")
        assert out == jax_bc2.transform(data, s)
        assert bc2.untransform(out, port, device="cpu") == data


def test_stream_offsets_follow_the_stream_spec():
    """The streams sit where ``hostwrap.bc2_stream_spec`` puts them: for split
    colour, alpha at 0, c0 at 8n, c1 at 10n, colour indices at 12n."""
    from dxt_lossless_transform_tpu.ops.hostwrap import bc2_stream_spec

    n = 3
    s = JaxSettings(0, True)
    assert bc2_stream_spec(s) == (8, 2, 2, 4)
    blocks = np.arange(16 * n, dtype=np.uint8).reshape(n, 16)
    out = np.frombuffer(bc2.transform(blocks.tobytes(), convert.from_reference(s),
                                      device="cpu"), np.uint8)
    np.testing.assert_array_equal(out[:8 * n], blocks[:, :8].reshape(-1))
    np.testing.assert_array_equal(out[8 * n:10 * n], blocks[:, 8:10].reshape(-1))
    np.testing.assert_array_equal(out[10 * n:12 * n], blocks[:, 10:12].reshape(-1))
    np.testing.assert_array_equal(out[12 * n:], blocks[:, 12:].reshape(-1))
