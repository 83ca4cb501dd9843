"""The RGBA8888, BGRA8888 and BGR888 channel kernels' plain versions and the port's
bytes-to-bytes RGB transforms (``device="cpu"``) against the JAX package: its numpy
oracle at every layout, setting and odd pixel count, its Pallas channel kernels in
interpret mode at one of their tiles, and its ``ops.rgb`` entry points, errors
included. Exact equality everywhere."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu import errors as jax_errors
from dxt_lossless_transform_tpu.ops import rgb as jax_rgb
from dxt_lossless_transform_tpu.ops.pallas.channels import (
    W_BGR, merge_bgr_tpu, merge_channels_tpu, split_bgr_tpu, split_channels_tpu,
)
from dxt_lossless_transform_tpu.ops.pallas.shuffle import MAX_ROWS, WIDTH
from dxt_lossless_transform_tpu.oracle import rgb as oracle_rgb
from dxt_lossless_transform_tpu.settings import RgbTransformSettings as JaxSettings
from dxt_lossless_transform_tpu_torch import backend
from dxt_lossless_transform_tpu_torch.errors import RgbValidationError
from dxt_lossless_transform_tpu_torch.ops import rgb
from dxt_lossless_transform_tpu_torch.ops.cuda import channels
from dxt_lossless_transform_tpu_torch.settings import RgbTransformSettings

LAYOUTS = tuple(channels.LAYOUTS)
SETTINGS = list(RgbTransformSettings.all_combinations())
SIZES = [1, 2, 3, 5, 4097]
# one tile of the JAX package's channel kernels, in pixels
TILE = MAX_ROWS * WIDTH
BGR_TILE = MAX_ROWS * 4 * (W_BGR // 3)


def _jax(settings: RgbTransformSettings) -> JaxSettings:
    return JaxSettings(settings.decorrelate, settings.split_channels)


def _pixels(layout: str, n: int, seed: int) -> bytes:
    stride = channels.LAYOUTS[layout][0]
    return np.random.default_rng(seed).integers(0, 256, stride * n, np.uint8).tobytes()


def _tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def test_layouts_are_the_reference_ones():
    assert channels.LAYOUTS == oracle_rgb._LAYOUTS


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("s", SETTINGS, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_versions_match_oracle(layout, s, n):
    data = _pixels(layout, n, n)
    args = (*channels.LAYOUTS[layout], s.decorrelate, s.split_channels)
    t = channels.rgb_transform(_tensor(data), *args)
    assert t.numpy().tobytes() == oracle_rgb.transform(data, layout, _jax(s))
    u = channels.rgb_untransform(t, *args)
    assert u.numpy().tobytes() == data


def test_split_channels_matches_pallas():
    _, ri, gi, bi = channels.LAYOUTS["rgba8888"]
    data = _pixels("rgba8888", TILE, 21)
    streams = split_channels_tpu(jnp.asarray(np.frombuffer(data, "<u4")), ri, gi, bi,
                                 True, interpret=True)
    want = b"".join(np.asarray(s).astype("<u4").tobytes() for s in streams)
    got = channels.rgb_transform(_tensor(data), 4, ri, gi, bi, True, True)
    assert got.numpy().tobytes() == want


def test_merge_channels_matches_pallas():
    _, ri, gi, bi = channels.LAYOUTS["bgra8888"]
    data = _pixels("bgra8888", TILE, 22)
    streams = tuple(jnp.asarray(np.frombuffer(data[c * TILE:(c + 1) * TILE], "<u4"))
                    for c in range(4))
    want = np.asarray(merge_channels_tpu(streams, ri, gi, bi, True, interpret=True))
    got = channels.rgb_untransform(_tensor(data), 4, ri, gi, bi, True, True)
    assert got.numpy().tobytes() == want.astype("<u4").tobytes()


def test_split_bgr_matches_pallas():
    data = _pixels("bgr888", BGR_TILE, 23)
    streams = split_bgr_tpu(np.frombuffer(data, "<u4"), True, interpret=True)
    want = b"".join(np.asarray(s).astype("<u4").tobytes() for s in streams)
    got = channels.rgb_transform(_tensor(data), *channels.LAYOUTS["bgr888"], True, True)
    assert got.numpy().tobytes() == want


def test_merge_bgr_matches_pallas():
    data = _pixels("bgr888", BGR_TILE, 24)
    streams = tuple(np.frombuffer(data[c * BGR_TILE:(c + 1) * BGR_TILE], "<u4")
                    for c in range(3))
    want = np.asarray(merge_bgr_tpu(streams, True, interpret=True))
    got = channels.rgb_untransform(_tensor(data), *channels.LAYOUTS["bgr888"], True,
                                   True)
    assert got.numpy().tobytes() == want.astype("<u4").tobytes()


@pytest.mark.parametrize("s", SETTINGS, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_bytes_api_matches_jax(layout, s):
    data = _pixels(layout, 3001, 7)
    t = rgb.transform(data, layout, s, device="cpu")
    assert t == jax_rgb.transform(data, layout, _jax(s))
    assert rgb.untransform(t, layout, s, device="cpu") == data
    assert jax_rgb.untransform(t, layout, _jax(s)) == data


@pytest.mark.parametrize("layout", LAYOUTS)
def test_empty_and_unaligned_input_as_jax(layout):
    stride = channels.LAYOUTS[layout][0]
    for fn, jax_fn in ((rgb.transform, jax_rgb.transform),
                       (rgb.untransform, jax_rgb.untransform)):
        assert fn(b"", layout, device="cpu") == jax_fn(b"", layout) == b""
        for length in (1, stride - 1, stride + 1, 7 * stride + 2):
            with pytest.raises(RgbValidationError) as port:
                fn(bytes(length), layout, device="cpu")
            with pytest.raises(jax_errors.RgbValidationError) as jax:
                jax_fn(bytes(length), layout)
            assert (port.value.fmt, port.value.length, port.value.divisor) == \
                (jax.value.fmt, jax.value.length, jax.value.divisor)
            assert str(port.value) == str(jax.value)
            assert isinstance(port.value, ValueError)


def test_identity_launches_nothing(monkeypatch):
    """The identity returns the input's bytes without calling a wrapper."""
    def boom(*args, **kwargs):
        raise AssertionError("the identity called a kernel wrapper")

    monkeypatch.setattr(channels, "rgb_transform", boom)
    monkeypatch.setattr(channels, "rgb_untransform", boom)
    identity = RgbTransformSettings(False, False)
    for layout in LAYOUTS:
        data = _pixels(layout, 9, 3)
        assert rgb.transform(data, layout, identity, device="cpu") == data
        assert rgb.untransform(data, layout, identity, device="cpu") == data


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_out_at_an_offset(offset):
    """The auto-search writes candidates into rows of one tensor: any offset."""
    stride, ri, gi, bi = channels.LAYOUTS["bgr888"]
    n = 4099
    x = _tensor(_pixels("bgr888", n, offset))
    buf = torch.full((stride * n + 8,), 0xAB, dtype=torch.uint8)
    row = buf[offset:offset + stride * n]
    assert channels.rgb_transform(x, stride, ri, gi, bi, True, True, out=row) is row
    assert torch.equal(row, channels.rgb_transform_plain(x, stride, ri, gi, bi, True,
                                                         True))
    assert bool((buf[:offset] == 0xAB).all())
    assert bool((buf[offset + stride * n:] == 0xAB).all())


def test_wrappers_check_their_inputs():
    x = torch.zeros(12, dtype=torch.uint8)
    with pytest.raises(ValueError):  # no layout has this channel map
        channels.rgb_transform(x, 4, 0, 2, 1, True, True)
    with pytest.raises(ValueError):
        channels.rgb_transform(x, 5, 0, 1, 2, True, True)
    with pytest.raises(ValueError):  # not a whole number of pixels
        channels.rgb_untransform(torch.zeros(10, dtype=torch.uint8), 4, 0, 1, 2, True,
                                 True)
    with pytest.raises(ValueError):
        channels.rgb_transform(x.to(torch.int16), 3, 2, 1, 0, True, True)
    with pytest.raises(ValueError):
        channels.rgb_transform(x, 3, 2, 1, 0, True, True,
                               out=torch.zeros(9, dtype=torch.uint8))
    with pytest.raises(KeyError):
        rgb.transform(bytes(12), "rgb565", device="cpu")


def test_cpu_tensors_launch_nothing():
    backend.reset_launch_counts()
    for layout, (dec, split) in itertools.product(
            LAYOUTS, itertools.product((True, False), repeat=2)):
        args = (*channels.LAYOUTS[layout], dec, split)
        x = _tensor(_pixels(layout, 33, 1))
        assert torch.equal(channels.rgb_untransform(channels.rgb_transform(x, *args),
                                                    *args), x)
    assert backend.LAUNCHES["dlt_rgb_transform"] == 0
    assert backend.LAUNCHES["dlt_rgb_untransform"] == 0
