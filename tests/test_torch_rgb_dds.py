"""Whole RGBA8888, BGRA8888 and BGR888 DDS files through the port's ``DdsHandler``
(plain versions, ``"cpu"``) against the JAX package's handler, both ways: files the
port writes untransform in the JAX package and the other way round, with manual
settings, the LTU auto-search and ``TransformBundle.default_all``, for the three
legacy-header layouts and a DX10 RGBA8888 file; the header bits; and the handler's
detection methods. Exact equality everywhere."""

import struct

import numpy as np
import pytest

from dxt_lossless_transform_tpu import api as jax_api
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.formats import errors as jax_format_errors
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle as JaxBundle
from dxt_lossless_transform_tpu.formats.embed import (
    TransformFormat as JaxFormat, TransformHeader as JaxHeader,
)
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler as JaxHandler
from dxt_lossless_transform_tpu.settings import RgbTransformSettings as JaxSettings
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import api
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.formats import errors
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.embed import (
    TransformFormat, TransformHeader,
)
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.settings import RgbTransformSettings
from dxt_lossless_transform_tpu_torch.utils import testgen

LAYOUTS = ("rgba8888", "bgra8888", "bgr888")
SETTINGS = list(RgbTransformSettings.all_combinations())
# (width, height): odd pixel counts, one pixel, a wide strip
SHAPES = [(16, 16), (13, 7), (1, 1), (130, 3)]
FORMAT = {"rgba8888": TransformFormat.RGBA8888, "bgra8888": TransformFormat.BGRA8888,
          "bgr888": TransformFormat.BGR888}


def _file(layout: str, shape, trailing: bytes = b"") -> bytes:
    w, h = shape
    if layout == "dx10_rgba8888":
        return _dx10_rgba8888(w, h) + trailing
    return jax_testgen.make_uncompressed_dds(layout, w, h, seed=w * h) + trailing


def _dx10_rgba8888(w: int, h: int) -> bytes:
    """A DX10-header file with DXGI_FORMAT_R8G8B8A8_UNORM (28), payload at 0x94."""
    header = bytearray(0x94)
    header[0:4] = b"DDS "
    struct.pack_into("<7I", header, 4, 124, 0x1007, h, w, 0, 0, 1)
    struct.pack_into("<2I", header, 0x4C, 32, 0x4)  # DDPF_FOURCC
    header[0x54:0x58] = b"DX10"
    struct.pack_into("<5I", header, 0x80, 28, 3, 0, 1, 0)
    struct.pack_into("<I", header, 0x6C, 0x1000)
    px = np.random.default_rng(w + h).normal(128, 20, (h, w, 4)).clip(0, 255)
    return bytes(header) + px.astype(np.uint8).tobytes()


def _slot(layout: str) -> str:
    return layout.replace("dx10_", "")


def _both_ways(data: bytes, port_bundle, jax_bundle) -> bytes:
    port = DdsHandler("cpu").transform_bundle(data, port_bundle)
    jax = JaxHandler().transform_bundle(data, jax_bundle)
    assert port == jax
    assert DdsHandler("cpu").untransform(jax) == data
    assert JaxHandler().untransform(port) == data
    return port


def test_testgen_matches_jax():
    for layout in LAYOUTS:
        for w, h in SHAPES:
            assert testgen.make_uncompressed_dds(layout, w, h, seed=3) == \
                jax_testgen.make_uncompressed_dds(layout, w, h, seed=3)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("s", SETTINGS, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS + ("dx10_rgba8888",))
def test_manual_files_match_jax(layout, s, shape):
    slot = _slot(layout)
    data = _file(layout, shape, trailing=b"tail")
    _both_ways(data,
               TransformBundle(**{slot: api.RgbManualTransformBuilder(slot, s)}),
               JaxBundle(**{slot: jax_api.RgbManualTransformBuilder(
                   slot, JaxSettings(s.decorrelate, s.split_channels))}))


@pytest.mark.parametrize("layout", LAYOUTS + ("dx10_rgba8888",))
def test_auto_files_match_jax(layout):
    slot = _slot(layout)
    data = _file(layout, (48, 40))
    out = _both_ways(data,
                     TransformBundle(**{slot: api.RgbAutoTransformBuilder(
                         slot, LtuEstimation())}),
                     JaxBundle(**{slot: jax_api.RgbAutoTransformBuilder(slot, JaxLtu())}))
    assert TransformHeader.from_bytes(out).format == FORMAT[slot]


@pytest.mark.parametrize("layout", LAYOUTS + ("dx10_rgba8888",))
def test_default_all_matches_jax(layout):
    data = _file(layout, (13, 7))
    out = _both_ways(data, TransformBundle.default_all(), JaxBundle.default_all())
    assert TransformHeader.from_bytes(out).rgb_settings() == RgbTransformSettings()


def test_default_all_holds_every_manual_default():
    port, jax = TransformBundle.default_all(), JaxBundle.default_all()
    for slot in ("bc1", "bc2", "bc3", "bc4", "bc5", "bc7", "bc6h", "rgba8888",
                 "bgra8888", "bgr888"):
        builder, jax_builder = getattr(port, slot), getattr(jax, slot)
        assert type(builder).__name__ == type(jax_builder).__name__
        assert builder.get_settings().__dict__ == {
            k: (int(v) if hasattr(v, "value") else v)
            for k, v in jax_builder.get_settings().__dict__.items()}
    for slot in ("rgba8888", "bgra8888", "bgr888"):
        assert getattr(port, slot).layout == slot


@pytest.mark.parametrize("s", SETTINGS, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_header_bits_match_jax(layout, s):
    header = TransformHeader.for_rgb(FORMAT[layout], s)
    jax = JaxHeader.for_rgb(JaxFormat[layout.upper()],
                            JaxSettings(s.decorrelate, s.split_channels))
    assert header.to_bytes() == jax.to_bytes()
    assert TransformHeader.from_bytes(jax.to_bytes()).rgb_settings() == s


def test_header_errors_match_jax():
    with pytest.raises(errors.UnknownTransformFormat):
        TransformHeader.for_rgb(TransformFormat.BC1, RgbTransformSettings())
    with pytest.raises(jax_format_errors.UnknownTransformFormat):
        JaxHeader.for_rgb(JaxFormat.BC1, JaxSettings())
    for version in (1, 2, 3):
        bad = TransformHeader(TransformFormat.BGR888, version | 0xC)
        with pytest.raises(errors.CorruptedEmbeddedData) as port:
            bad.rgb_settings()
        with pytest.raises(jax_format_errors.CorruptedEmbeddedData) as jax:
            JaxHeader(JaxFormat.BGR888, version | 0xC).rgb_settings()
        assert str(port.value) == str(jax.value)


def test_detection_matches_jax():
    dds = _file("bgr888", (8, 8))
    transformed = JaxHandler().transform_bundle(dds, JaxBundle.default_all())
    bc7 = jax_testgen.make_dx10_dds("BC7", 8, 8)
    cases = [dds, transformed, bc7, b"", b"DDS ", b"DDS " + bytes(200),
             bytes(200), b"\x0f" + bytes(200), dds[:0x7F], transformed[:100],
             b"\x05\x00\x00\x00" + dds[4:0x54] + b"\xff" * 200]
    port, jax = DdsHandler("cpu"), JaxHandler()
    for data in cases:
        assert port.can_handle(data) == jax.can_handle(data)
        assert port.can_handle(data, "dds") == jax.can_handle(data, "dds")
        assert port.can_handle_untransform(data) == jax.can_handle_untransform(data)
    assert port.can_handle(dds) and not port.can_handle(transformed)
    assert port.can_handle_untransform(transformed)
    assert not port.can_handle_untransform(b"DDS")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_truncated_and_unaligned_files_raise_as_jax(layout):
    data = _file(layout, (16, 16))
    bundle = TransformBundle.default_all()
    for bad in (data[:-1], data[:0x80 + 5]):
        with pytest.raises(errors.InputTooShortForStatedTextureSize):
            DdsHandler("cpu").transform_bundle(bad, bundle)
        with pytest.raises(jax_format_errors.InputTooShortForStatedTextureSize):
            JaxHandler().transform_bundle(bad, JaxBundle.default_all())
    out = DdsHandler("cpu").transform_bundle(data, bundle)
    with pytest.raises(errors.InputTooShortForStatedTextureSize):
        DdsHandler("cpu").untransform(out[:-3])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bundle_without_the_rgb_builder_raises(layout):
    data = _file(layout, (8, 8))
    with pytest.raises(errors.NoBuilderForFormat) as port:
        DdsHandler("cpu").transform_bundle(data, TransformBundle(
            bc1=api.Bc1ManualTransformBuilder()))
    with pytest.raises(jax_format_errors.NoBuilderForFormat) as jax:
        JaxHandler().transform_bundle(data, JaxBundle(
            bc1=jax_api.Bc1ManualTransformBuilder()))
    assert str(port.value) == str(jax.value)
