"""The port's BC3 transform and untransform (plain versions, ``device="cpu"``)
against the JAX package, byte for byte."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.ops import bc3 as jax_bc3
from dxt_lossless_transform_tpu.ops.pallas.shuffle import (
    bc3_transform_tpu, bc3_untransform_tpu,
)
from dxt_lossless_transform_tpu.settings import Bc3TransformSettings as JaxSettings
from dxt_lossless_transform_tpu.utils.testgen import bc3_realistic
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import Bc3ValidationError
from dxt_lossless_transform_tpu_torch.ops import bc3
from dxt_lossless_transform_tpu_torch.ops.cuda import shuffle

SETTINGS = list(JaxSettings.all_combinations())


def _data(n: int, kind: str) -> bytes:
    if kind == "realistic":
        return bc3_realistic(n, seed=n)
    return np.random.default_rng(n).integers(0, 256, 16 * n, np.uint8).tobytes()


# 70,000 blocks (1.12 MB) is above the JAX package's 1 MiB device threshold, so
# there it takes its device path; below, its host path.
@pytest.mark.parametrize("n", [1, 2, 3, 5, 2047, 2049, 70000])
@pytest.mark.parametrize("settings", SETTINGS, ids=str)
def test_matches_jax(settings, n):
    data = _data(n, "random" if n % 2 else "realistic")
    port = convert.from_reference(settings)
    want = jax_bc3.transform(data, settings)
    got = bc3.transform(data, port, device="cpu")
    assert got == want
    assert bc3.untransform(got, port, device="cpu") == data
    assert jax_bc3.untransform(got, settings) == data


@pytest.mark.parametrize("settings", SETTINGS, ids=str)
def test_matches_pallas_kernels_interpret(settings):
    """At n=512 the streams also equal the TPU kernels' (interpret mode)."""
    n = 512
    data = _data(n, "random")
    args = (int(settings.decorrelation_mode), settings.split_alpha_endpoints,
            settings.split_colour_endpoints)
    streams = bc3_transform_tpu(jnp.asarray(np.frombuffer(data, "<u4")), *args,
                                interpret=True)
    want = b"".join(np.asarray(s).astype("<u4").tobytes() for s in streams)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = shuffle.bc3_transform(x, *args)
    assert got.numpy().tobytes() == want
    back = bc3_untransform_tpu(streams, *args, interpret=True)
    assert np.asarray(back).astype("<u4").tobytes() == data
    assert shuffle.bc3_untransform(got, *args).numpy().tobytes() == data


@pytest.mark.parametrize("length", [1, 8, 15, 17, 4100])
@pytest.mark.parametrize("fn", [bc3.transform, bc3.untransform])
def test_wrong_length_raises(fn, length):
    with pytest.raises(Bc3ValidationError):
        fn(bytes(length), device="cpu")


@pytest.mark.parametrize("fn", [bc3.transform, bc3.untransform])
def test_empty(fn):
    assert fn(b"", device="cpu") == b""


def test_bit31_colour_words_and_extreme_alpha():
    """Colour words with c1's top bit set, and alpha bytes 0 and 255, survive every
    setting."""
    words = np.full((65, 4), 0xFFFF8000, dtype="<u4")
    words[::2, 0] = 0x00FF00FF
    words[1::2, 0] = 0xFFFFFF00
    words[::3, 2] = 0x80017FFF
    data = words.tobytes()
    for s in SETTINGS:
        port = convert.from_reference(s)
        out = bc3.transform(data, port, device="cpu")
        assert out == jax_bc3.transform(data, s)
        assert bc3.untransform(out, port, device="cpu") == data


def test_stream_offsets_follow_the_stream_spec():
    """The streams sit where ``hostwrap.bc3_stream_spec`` puts them: for split alpha
    and split colour, a0 at 0, a1 at n, indices at 2n, c0 at 8n, c1 at 10n, colour
    indices at 12n."""
    from dxt_lossless_transform_tpu.ops.hostwrap import bc3_stream_spec

    n = 3
    s = JaxSettings(0, True, True)
    assert bc3_stream_spec(s) == (1, 1, 6, 2, 2, 4)
    blocks = np.arange(16 * n, dtype=np.uint8).reshape(n, 16)
    out = np.frombuffer(bc3.transform(blocks.tobytes(), convert.from_reference(s),
                                      device="cpu"), np.uint8)
    np.testing.assert_array_equal(out[:n], blocks[:, 0])
    np.testing.assert_array_equal(out[n:2 * n], blocks[:, 1])
    np.testing.assert_array_equal(out[2 * n:8 * n], blocks[:, 2:8].reshape(-1))
    np.testing.assert_array_equal(out[8 * n:10 * n], blocks[:, 8:10].reshape(-1))
    np.testing.assert_array_equal(out[10 * n:12 * n], blocks[:, 10:12].reshape(-1))
    np.testing.assert_array_equal(out[12 * n:], blocks[:, 12:].reshape(-1))
