"""DDS files end to end: the port and the JAX package write identical transformed
files, each untransforms the other's, and both raise the same errors."""

import struct

import pytest

from dxt_lossless_transform_tpu.api import (
    Bc1AutoTransformBuilder as JaxAuto, Bc1ManualTransformBuilder as JaxManual,
)
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle as JaxBundle
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler as JaxHandler
from dxt_lossless_transform_tpu.settings import Bc1TransformSettings as JaxSettings
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.api import (
    Bc1AutoTransformBuilder, Bc1ManualTransformBuilder,
)
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.formats import dds, errors
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.utils import testgen


def _cubemap(size: int, mips: int) -> bytes:
    """A legacy-header BC1 cubemap: six full mip chains, caps2 face bits set."""
    one = testgen.make_dds("BC1", size, size, mips, seed=9)
    faces = b"".join(testgen.bc1_realistic(len(one[0x80:]) // 8, seed=f)
                     for f in range(6))
    header = bytearray(one[:0x80])
    struct.pack_into("<I", header, 0x70, 0x200 | 0xFC00)
    return bytes(header) + faces


FILES = {
    "4x4": lambda: testgen.make_dds("BC1", 4, 4),
    "64-full-mips": lambda: testgen.make_dds("BC1", 64, 64, 7, seed=1),
    "100x60-trailing": lambda: testgen.make_dds("BC1", 100, 60, 3, seed=2,
                                                trailing=b"tail bytes"),
    "2x2-random": lambda: testgen.make_dds("BC1", 2, 2, 2, realistic=False),
    "dx10-32-mips": lambda: testgen.make_dx10_dds("BC1", 32, 32, 6, seed=4),
    "dx10-trailing": lambda: testgen.make_dx10_dds("BC1", 8, 24, 1, trailing=b"\x01"),
    "cubemap": lambda: _cubemap(16, 5),
    "256-full-mips": lambda: testgen.make_dds("BC1", 256, 256, 9, seed=5),
}
BUILDERS = {
    "auto-fast": (lambda: JaxAuto(JaxLtu()),
                  lambda: Bc1AutoTransformBuilder(LtuEstimation())),
    "auto-comprehensive": (
        lambda: JaxAuto(JaxLtu()).use_all_decorrelation_modes(True),
        lambda: Bc1AutoTransformBuilder.new_ultra(LtuEstimation())),
    "manual-var3-split": (
        lambda: JaxManual(JaxSettings(3, True)),
        lambda: Bc1ManualTransformBuilder(convert.from_reference(JaxSettings(3, True)))),
}


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("name", FILES)
def test_files_match_jax_and_cross_untransform(name, builder):
    data = FILES[name]()
    jax_builder, port_builder = BUILDERS[builder]
    want = JaxHandler().transform_bundle(data, JaxBundle(bc1=jax_builder()))
    got = DdsHandler("cpu").transform_bundle(data, TransformBundle(bc1=port_builder()))
    assert got == want
    assert DdsHandler("cpu").untransform(got) == data
    assert DdsHandler("cpu").untransform(want) == data  # JAX-written, port-read
    assert JaxHandler().untransform(got) == data        # port-written, JAX-read


def _error_name(fn) -> str:
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__


@pytest.mark.parametrize("data", [b"not a dds file" * 20, b"DDS ", b""],
                         ids=["text", "magic-only", "empty"])
def test_non_dds_raises_as_jax(data):
    port = _error_name(lambda: DdsHandler("cpu").transform_bundle(
        data, TransformBundle(bc1=Bc1ManualTransformBuilder())))
    jax = _error_name(lambda: JaxHandler().transform_bundle(
        data, JaxBundle(bc1=JaxManual())))
    assert port == jax


@pytest.mark.parametrize("fmt", ["BC2", "BC3", "BC4", "BC5"])
def test_non_bc1_dds_raises_as_jax(fmt):
    data = jax_testgen.make_dds(fmt, 8, 8)
    port = _error_name(lambda: DdsHandler("cpu").transform_bundle(
        data, TransformBundle(bc1=Bc1ManualTransformBuilder())))
    jax = _error_name(lambda: JaxHandler().transform_bundle(
        data, JaxBundle(bc1=JaxManual())))
    assert port == jax == "NoBuilderForFormat"


def test_non_bc1_header_is_unsupported_on_untransform():
    """Every format's header is supported on untransform now that the RGB formats
    are ported: a JAX-written BGR888 file (decorrelated, not split) untransforms in
    the port to the JAX package's bytes."""
    data = jax_testgen.make_uncompressed_dds("bgr888", 9, 7)
    from dxt_lossless_transform_tpu.api import RgbManualTransformBuilder

    transformed = JaxHandler().transform_bundle(
        data, JaxBundle(bgr888=RgbManualTransformBuilder("bgr888").split_channels(False)))
    assert DdsHandler("cpu").untransform(transformed) == \
        JaxHandler().untransform(transformed) == data


def test_truncated_file_raises_as_jax():
    data = testgen.make_dds("BC1", 16, 16, 3)[:-8]
    port = _error_name(lambda: DdsHandler("cpu").transform_bundle(
        data, TransformBundle(bc1=Bc1ManualTransformBuilder())))
    jax = _error_name(lambda: JaxHandler().transform_bundle(
        data, JaxBundle(bc1=JaxManual())))
    assert port == jax == "InputTooShortForStatedTextureSize"


def test_the_handler_device_decides_both_directions():
    """Builders and estimators carry no device: ``DdsHandler("cpu")`` runs the
    default auto builder's search and transform on the CPU, and its untransform."""
    data = testgen.make_dds("BC1", 32, 32, 4, seed=6)
    handler = DdsHandler("cpu")
    out = handler.transform_bundle(
        data, TransformBundle(bc1=Bc1AutoTransformBuilder(LtuEstimation())))
    assert handler.untransform(out) == data


def test_missing_builder_raises():
    with pytest.raises(errors.NoBuilderForFormat):
        DdsHandler("cpu").transform_bundle(testgen.make_dds("BC1", 8, 8),
                                           TransformBundle())


@pytest.mark.parametrize("settings", list(JaxSettings.all_combinations()), ids=str)
def test_header_matches_jax(settings):
    from dxt_lossless_transform_tpu.formats.embed import TransformHeader as JaxHeader

    port = TransformHeader.for_bc1(convert.from_reference(settings))
    assert port.to_bytes() == JaxHeader.for_bc1(settings).to_bytes()
    assert TransformHeader.from_bytes(port.to_bytes()).bc1_settings() == \
        convert.from_reference(settings)


@pytest.mark.parametrize("name", FILES)
def test_parse_matches_jax(name):
    from dxt_lossless_transform_tpu.formats import dds as jax_dds

    data = FILES[name]()
    port, want = dds.parse_dds(data), jax_dds.parse_dds(data)
    assert (port.format.name, port.data_offset, port.data_length) == \
        (want.format.name, want.data_offset, want.data_length)


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_testgen_bytes_match_jax(seed):
    assert testgen.bc1_realistic(999, seed) == jax_testgen.bc1_realistic(999, seed)
    assert testgen.make_dds("BC1", 40, 24, 4, seed=seed, trailing=b"x") == \
        jax_testgen.make_dds("BC1", 40, 24, 4, seed=seed, trailing=b"x")
    assert testgen.make_dds("BC1", 8, 8, 1, seed=seed, realistic=False) == \
        jax_testgen.make_dds("BC1", 8, 8, 1, seed=seed, realistic=False)
    assert testgen.make_dx10_dds("BC1", 20, 12, 3, seed=seed) == \
        jax_testgen.make_dx10_dds("BC1", 20, 12, 3, seed=seed)
