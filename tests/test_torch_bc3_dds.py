"""BC3 DDS files end to end: the port and the JAX package write identical
transformed files, each untransforms the other's, and the headers and synthetic
files agree."""

import pytest

from dxt_lossless_transform_tpu.api import (
    Bc3AutoTransformBuilder as JaxAuto, Bc3ManualTransformBuilder as JaxManual,
)
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle as JaxBundle
from dxt_lossless_transform_tpu.formats.embed import TransformHeader as JaxHeader
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler as JaxHandler
from dxt_lossless_transform_tpu.settings import Bc3TransformSettings as JaxSettings
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.api import (
    Bc1ManualTransformBuilder, Bc3AutoTransformBuilder, Bc3ManualTransformBuilder,
)
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.formats import errors
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.settings import Bc3TransformSettings
from dxt_lossless_transform_tpu_torch.utils import testgen

FILES = {
    "4x4": lambda: testgen.make_dds("BC3", 4, 4),
    "64-full-mips": lambda: testgen.make_dds("BC3", 64, 64, 7, seed=1),
    "100x60-trailing": lambda: testgen.make_dds("BC3", 100, 60, 3, seed=2,
                                                trailing=b"tail bytes"),
    "2x2-random": lambda: testgen.make_dds("BC3", 2, 2, 2, realistic=False),
    "dx10-32-mips": lambda: testgen.make_dx10_dds("BC3", 32, 32, 6, seed=4),
    "dx10-trailing": lambda: testgen.make_dx10_dds("BC3", 8, 24, 1, trailing=b"\x01"),
    "256-full-mips": lambda: testgen.make_dds("BC3", 256, 256, 9, seed=5),
}
BUILDERS = {
    "auto-fast": lambda: JaxAuto(JaxLtu()),
    "auto-comprehensive": lambda: JaxAuto(JaxLtu()).use_all_decorrelation_modes(True),
    "manual-var3-split-alpha": lambda: JaxManual(JaxSettings(3, True, False)),
    "manual-none-split-colour": lambda: JaxManual(JaxSettings(0, False, True)),
}


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("name", FILES)
def test_files_match_jax_and_cross_untransform(name, builder):
    data = FILES[name]()
    jax_builder = BUILDERS[builder]()
    want = JaxHandler().transform_bundle(data, JaxBundle(bc3=jax_builder))
    got = DdsHandler("cpu").transform_bundle(
        data, TransformBundle(bc3=convert.from_reference(jax_builder)))
    assert got == want
    assert DdsHandler("cpu").untransform(got) == data
    assert DdsHandler("cpu").untransform(want) == data  # JAX-written, port-read
    assert JaxHandler().untransform(got) == data        # port-written, JAX-read


def test_builders_carry_across():
    auto = convert.from_reference(JaxAuto.new_ultra(JaxLtu((1, 4, 9))))
    assert isinstance(auto, Bc3AutoTransformBuilder) and auto._use_all
    assert auto._estimator.offsets == (1, 4, 9)
    manual = convert.from_reference(JaxManual(JaxSettings(2, True, False)))
    assert isinstance(manual, Bc3ManualTransformBuilder)
    assert manual.get_settings() == Bc3TransformSettings(2, True, False)


def test_manual_builder_setters():
    b = Bc3ManualTransformBuilder().decorrelation_mode(3).split_alpha_endpoints(True)
    b = b.split_colour_endpoints(True)
    assert b.get_settings() == Bc3TransformSettings(3, True, True)
    want = JaxManual().decorrelation_mode(3).split_alpha_endpoints(True)
    assert convert.from_reference(want.split_colour_endpoints(True).get_settings()) \
        == b.get_settings()


@pytest.mark.parametrize("settings", list(JaxSettings.all_combinations()), ids=str)
def test_header_matches_jax(settings):
    port = TransformHeader.for_bc3(convert.from_reference(settings))
    assert port.to_bytes() == JaxHeader.for_bc3(settings).to_bytes()
    assert TransformHeader.from_bytes(port.to_bytes()).bc3_settings() == \
        convert.from_reference(settings)


def test_bc1_and_bc3_in_one_bundle():
    bundle = TransformBundle(bc1=Bc1ManualTransformBuilder(),
                             bc3=Bc3AutoTransformBuilder(LtuEstimation()))
    for fmt in ("BC1", "BC3"):
        data = testgen.make_dds(fmt, 32, 32, 4, seed=8)
        out = DdsHandler("cpu").transform_bundle(data, bundle)
        assert DdsHandler("cpu").untransform(out) == data


def test_bc3_without_its_builder_raises_as_jax():
    data = testgen.make_dds("BC3", 8, 8)
    with pytest.raises(errors.NoBuilderForFormat):
        DdsHandler("cpu").transform_bundle(
            data, TransformBundle(bc1=Bc1ManualTransformBuilder()))


@pytest.mark.parametrize("fmt", ["BC2", "BC4", "BC5"])
def test_later_slices_still_raise(fmt):
    """BC2, BC4 and BC5 came with a later slice: a bundle without their builder
    raises for want of the builder, no longer for want of the format."""
    data = jax_testgen.make_dds(fmt, 8, 8)
    bundle = TransformBundle(bc3=Bc3ManualTransformBuilder())
    with pytest.raises(errors.NoBuilderForFormat) as info:
        DdsHandler("cpu").transform_bundle(data, bundle)
    assert "later slices" not in str(info.value)


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_testgen_bytes_match_jax(seed):
    assert testgen.bc3_realistic(999, seed) == jax_testgen.bc3_realistic(999, seed)
    assert testgen.make_dds("BC3", 40, 24, 4, seed=seed, trailing=b"x") == \
        jax_testgen.make_dds("BC3", 40, 24, 4, seed=seed, trailing=b"x")
    assert testgen.make_dds("BC3", 8, 8, 1, seed=seed, realistic=False) == \
        jax_testgen.make_dds("BC3", 8, 8, 1, seed=seed, realistic=False)
    assert testgen.make_dx10_dds("BC3", 20, 12, 3, seed=seed) == \
        jax_testgen.make_dx10_dds("BC3", 20, 12, 3, seed=seed)


def test_smoke_file_shape():
    """The chip smoke run's BC3 file: 1,398,103 blocks, a 22,369,648-byte payload."""
    assert testgen._chain_blocks(4096, 4096, 13) == 1398103
    assert 16 * testgen._chain_blocks(4096, 4096, 13) == 22369648
