"""The port's file-format API (plain versions, ``DdsHandler("cpu")``) against the JAX
package's: the slice functions and the multi-handler dispatch over bytes, and file
in, file out on a temporary directory, with ``NoSupportedHandler`` where no handler
accepts the data. Exact equality everywhere."""

import pytest

from dxt_lossless_transform_tpu import api as jax_api
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.formats import api as jax_fapi, file_io as jax_file_io
from dxt_lossless_transform_tpu.formats import errors as jax_format_errors
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle as JaxBundle
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler as JaxHandler
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import api
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.formats import api as fapi, errors, file_io
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.handlers import (
    DdsHandler, FileFormatHandler,
)

FILES = {
    "rgba8888": lambda: jax_testgen.make_uncompressed_dds("rgba8888", 24, 20, seed=1),
    "bgra8888": lambda: jax_testgen.make_uncompressed_dds("bgra8888", 17, 9, seed=2),
    "bgr888": lambda: jax_testgen.make_uncompressed_dds("bgr888", 31, 5, seed=3),
    "BC1": lambda: jax_testgen.make_dds("BC1", 32, 32, 3, seed=4),
    "BC7": lambda: jax_testgen.make_dx10_dds("BC7", 16, 16, 2, seed=5),
}


def _auto_bundles():
    """The LTU auto builders of the three RGB formats, in both packages."""
    port = TransformBundle(**{layout: api.RgbAutoTransformBuilder(layout, LtuEstimation())
                              for layout in ("rgba8888", "bgra8888", "bgr888")})
    jax = JaxBundle(**{layout: jax_api.RgbAutoTransformBuilder(layout, JaxLtu())
                       for layout in ("rgba8888", "bgra8888", "bgr888")})
    return port, jax


class AcceptsAll:
    """A handler without detection methods: the dispatch takes it for anything."""

    def __init__(self):
        self.calls = []

    def transform_bundle(self, data, bundle):
        self.calls.append("transform")
        return b"T" + data

    def untransform(self, data):
        self.calls.append("untransform")
        return data[1:]


def test_dds_handler_is_a_file_format_handler():
    assert isinstance(DdsHandler("cpu"), FileFormatHandler)
    assert isinstance(AcceptsAll(), FileFormatHandler)


@pytest.mark.parametrize("name", FILES)
def test_slice_api_matches_jax(name):
    data = FILES[name]()
    port = fapi.transform_slice_with_bundle(DdsHandler("cpu"), data,
                                            TransformBundle.default_all())
    jax = jax_fapi.transform_slice_with_bundle(JaxHandler(), data,
                                               JaxBundle.default_all())
    assert port == jax
    assert fapi.untransform_slice(DdsHandler("cpu"), jax) == data
    multi = fapi.transform_slice_with_multiple_handlers(
        [DdsHandler("cpu")], data, TransformBundle.default_all(), "dds")
    assert multi == port
    assert fapi.untransform_slice_with_multiple_handlers([DdsHandler("cpu")], port) \
        == data


@pytest.mark.parametrize("name", FILES)
def test_files_match_jax(name, tmp_path):
    data = FILES[name]()
    src, port_out, jax_out = (tmp_path / f"{n}.dds" for n in ("in", "port", "jax"))
    src.write_bytes(data)
    written = file_io.transform_file_with_handler(
        DdsHandler("cpu"), TransformBundle.default_all(), src, port_out)
    jax_written = jax_file_io.transform_file_with_handler(
        JaxHandler(), JaxBundle.default_all(), src, jax_out)
    assert written == jax_written == len(port_out.read_bytes())
    assert port_out.read_bytes() == jax_out.read_bytes()
    back = tmp_path / "back.dds"
    assert file_io.untransform_file_with_handler(DdsHandler("cpu"), jax_out, back) == \
        len(data)
    assert back.read_bytes() == data


@pytest.mark.parametrize("layout", ["rgba8888", "bgra8888", "bgr888"])
def test_multiple_handlers_files_match_jax(layout, tmp_path):
    data = jax_testgen.make_uncompressed_dds(layout, 40, 33, seed=9)
    src = tmp_path / "in.dds"
    src.write_bytes(data)
    port_bundle, jax_bundle = _auto_bundles()
    port_out, jax_out = tmp_path / "port.dds", tmp_path / "jax.dds"
    file_io.transform_file_with_multiple_handlers([DdsHandler("cpu")], port_bundle, src,
                                                  port_out)
    jax_file_io.transform_file_with_multiple_handlers([JaxHandler()], jax_bundle, src,
                                                      jax_out)
    assert port_out.read_bytes() == jax_out.read_bytes()
    for restored, out in ((tmp_path / "a.dds", jax_out), (tmp_path / "b.dds", port_out)):
        file_io.untransform_file_with_multiple_handlers([DdsHandler("cpu")], out, restored)
        assert restored.read_bytes() == data
    jax_back = tmp_path / "c.dds"
    jax_file_io.untransform_file_with_multiple_handlers([JaxHandler()], port_out,
                                                        jax_back)
    assert jax_back.read_bytes() == data


@pytest.mark.parametrize("content", [b"", b"not a texture" * 20, b"DDS "])
def test_no_supported_handler_as_jax(content, tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(content)
    out = tmp_path / "out.bin"
    for port_call, jax_call in (
            (lambda: file_io.transform_file_with_multiple_handlers(
                [DdsHandler("cpu")], TransformBundle.default_all(), src, out),
             lambda: jax_file_io.transform_file_with_multiple_handlers(
                [JaxHandler()], JaxBundle.default_all(), src, out)),
            (lambda: file_io.untransform_file_with_multiple_handlers(
                [DdsHandler("cpu")], src, out),
             lambda: jax_file_io.untransform_file_with_multiple_handlers(
                [JaxHandler()], src, out)),
            (lambda: fapi.transform_slice_with_multiple_handlers(
                [], content, TransformBundle.default_all()),
             lambda: jax_fapi.transform_slice_with_multiple_handlers(
                [], content, JaxBundle.default_all()))):
        with pytest.raises(errors.NoSupportedHandler) as port:
            port_call()
        with pytest.raises(jax_format_errors.NoSupportedHandler) as jax:
            jax_call()
        assert str(port.value) == str(jax.value)
        assert isinstance(port.value, errors.TransformError)
    assert not out.exists()


def test_handlers_are_tried_in_order():
    data = FILES["bgr888"]()
    fallback = AcceptsAll()
    out = fapi.transform_slice_with_multiple_handlers(
        [DdsHandler("cpu"), fallback], data, TransformBundle.default_all())
    assert out == DdsHandler("cpu").transform_bundle(data, TransformBundle.default_all())
    assert fallback.calls == []
    other = b"PNG" + bytes(100)
    assert fapi.transform_slice_with_multiple_handlers(
        [DdsHandler("cpu"), fallback], other, TransformBundle()) == b"T" + other
    assert fapi.untransform_slice_with_multiple_handlers(
        [DdsHandler("cpu"), fallback], b"T" + other) == other
    assert fallback.calls == ["transform", "untransform"]


def test_output_buffer_too_small_as_jax():
    port = errors.OutputBufferTooSmall(16, 8)
    jax = jax_format_errors.OutputBufferTooSmall(16, 8)
    assert str(port) == str(jax)
    assert (port.required, port.actual) == (16, 8)
    assert isinstance(port, errors.FormatHandlerError)
