"""BC2, BC4 and BC5 DDS files end to end: the port and the JAX package write
identical transformed files, each untransforms the other's, and the headers and
synthetic files agree."""

import pytest

from dxt_lossless_transform_tpu import api as jax_api
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle as JaxBundle
from dxt_lossless_transform_tpu.formats.embed import TransformHeader as JaxHeader
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler as JaxHandler
from dxt_lossless_transform_tpu import settings as jax_settings
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import api, convert
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.formats import errors
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.embed import TransformFormat, TransformHeader
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.utils import testgen

FORMATS = ("BC2", "BC4", "BC5")
FILES = {
    "4x4": lambda fmt: testgen.make_dds(fmt, 4, 4),
    "64-full-mips": lambda fmt: testgen.make_dds(fmt, 64, 64, 7, seed=1),
    "100x60-trailing": lambda fmt: testgen.make_dds(fmt, 100, 60, 3, seed=2,
                                                    trailing=b"tail bytes"),
    "2x2-random": lambda fmt: testgen.make_dds(fmt, 2, 2, 2, realistic=False),
    "dx10-32-mips": lambda fmt: testgen.make_dx10_dds(fmt, 32, 32, 6, seed=4),
    "256-full-mips": lambda fmt: testgen.make_dds(fmt, 256, 256, 9, seed=5),
}


def _jax_builders(fmt: str) -> dict:
    cap = fmt.capitalize()
    auto = getattr(jax_api, f"{cap}AutoTransformBuilder")
    manual = getattr(jax_api, f"{cap}ManualTransformBuilder")
    settings = getattr(jax_settings, f"{cap}TransformSettings")
    if fmt == "BC2":
        return {"auto-fast": lambda: auto(JaxLtu()),
                "auto-comprehensive": lambda: auto(JaxLtu()).use_all_decorrelation_modes(
                    True),
                "manual-a": lambda: manual(settings(3, False)),
                "manual-b": lambda: manual(settings(2, True))}
    return {"auto-fast": lambda: auto(JaxLtu()),
            "auto-comprehensive": lambda: auto.new_ultra(JaxLtu()),
            "manual-a": lambda: manual(settings(True)),
            "manual-b": lambda: manual(settings(False))}


@pytest.mark.parametrize("builder", ["auto-fast", "auto-comprehensive", "manual-a",
                                     "manual-b"])
@pytest.mark.parametrize("name", FILES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_files_match_jax_and_cross_untransform(fmt, name, builder):
    data = FILES[name](fmt)
    jax_builder = _jax_builders(fmt)[builder]()
    slot = fmt.lower()
    want = JaxHandler().transform_bundle(data, JaxBundle(**{slot: jax_builder}))
    got = DdsHandler("cpu").transform_bundle(
        data, TransformBundle(**{slot: convert.from_reference(jax_builder)}))
    assert got == want
    assert DdsHandler("cpu").untransform(got) == data
    assert DdsHandler("cpu").untransform(want) == data  # JAX-written, port-read
    assert JaxHandler().untransform(got) == data        # port-written, JAX-read


@pytest.mark.parametrize("fmt", FORMATS)
def test_builders_carry_across(fmt):
    cap = fmt.capitalize()
    jax_auto = getattr(jax_api, f"{cap}AutoTransformBuilder").new_ultra(JaxLtu((1, 4, 9)))
    port = convert.from_reference(jax_auto)
    assert isinstance(port, getattr(api, f"{cap}AutoTransformBuilder")) and port._use_all
    assert port._estimator.offsets == (1, 4, 9)
    jax_manual = _jax_builders(fmt)["manual-b"]()
    port = convert.from_reference(jax_manual)
    assert isinstance(port, getattr(api, f"{cap}ManualTransformBuilder"))
    assert port.get_settings() == convert.from_reference(jax_manual.get_settings())


def test_manual_builder_setters():
    b = api.Bc2ManualTransformBuilder().decorrelation_mode(2).split_colour_endpoints(False)
    want = jax_api.Bc2ManualTransformBuilder().decorrelation_mode(2)
    assert b.get_settings() == convert.from_reference(
        want.split_colour_endpoints(False).get_settings())
    for fmt in ("Bc4", "Bc5"):
        b = getattr(api, f"{fmt}ManualTransformBuilder")().split_endpoints(False)
        want = getattr(jax_api, f"{fmt}ManualTransformBuilder")().split_endpoints(False)
        assert b.get_settings() == convert.from_reference(want.get_settings())


@pytest.mark.parametrize("fmt", FORMATS)
def test_headers_match_jax(fmt):
    cap, low = fmt.capitalize(), fmt.lower()
    for settings in getattr(jax_settings, f"{cap}TransformSettings").all_combinations():
        port = getattr(TransformHeader, f"for_{low}")(convert.from_reference(settings))
        assert port.to_bytes() == getattr(JaxHeader, f"for_{low}")(settings).to_bytes()
        back = getattr(TransformHeader.from_bytes(port.to_bytes()), f"{low}_settings")()
        assert back == convert.from_reference(settings)


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_header_version_bits_are_checked_as_jax(fmt, version):
    low = fmt.lower()
    header = TransformHeader(TransformFormat[fmt], version | 4)
    jax_header = JaxHeader.from_bytes(header.to_bytes())
    with pytest.raises(errors.CorruptedEmbeddedData):
        getattr(header, f"{low}_settings")()
    with pytest.raises(Exception) as info:
        getattr(jax_header, f"{low}_settings")()
    assert type(info.value).__name__ == "CorruptedEmbeddedData"


def test_every_ported_format_in_one_bundle():
    bundle = TransformBundle(bc1=api.Bc1ManualTransformBuilder(),
                             bc2=api.Bc2AutoTransformBuilder(LtuEstimation()),
                             bc3=api.Bc3AutoTransformBuilder(LtuEstimation()),
                             bc4=api.Bc4AutoTransformBuilder(LtuEstimation()),
                             bc5=api.Bc5ManualTransformBuilder())
    for fmt in ("BC1", "BC2", "BC3", "BC4", "BC5"):
        data = testgen.make_dds(fmt, 32, 32, 4, seed=8)
        out = DdsHandler("cpu").transform_bundle(data, bundle)
        assert out != data and DdsHandler("cpu").untransform(out) == data


@pytest.mark.parametrize("fmt", FORMATS)
def test_missing_builder_raises_as_jax(fmt):
    data = testgen.make_dds(fmt, 8, 8)
    with pytest.raises(errors.NoBuilderForFormat):
        DdsHandler("cpu").transform_bundle(
            data, TransformBundle(bc1=api.Bc1ManualTransformBuilder()))


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("fmt", FORMATS)
def test_testgen_bytes_match_jax(fmt, seed):
    if fmt == "BC2":
        assert testgen.bc2_realistic(999, seed) == jax_testgen.bc2_realistic(999, seed)
    assert testgen.make_dds(fmt, 40, 24, 4, seed=seed, trailing=b"x") == \
        jax_testgen.make_dds(fmt, 40, 24, 4, seed=seed, trailing=b"x")
    assert testgen.make_dds(fmt, 8, 8, 1, seed=seed, realistic=False) == \
        jax_testgen.make_dds(fmt, 8, 8, 1, seed=seed, realistic=False)
    assert testgen.make_dx10_dds(fmt, 20, 12, 3, seed=seed) == \
        jax_testgen.make_dx10_dds(fmt, 20, 12, 3, seed=seed)


def test_smoke_file_shapes():
    """The chip smoke run's files: 1,398,103 blocks; BC2 and BC5 payloads of
    22,369,648 bytes, BC4's of 11,184,824."""
    n = testgen._chain_blocks(4096, 4096, 13)
    assert n == 1398103 and 16 * n == 22369648 and 8 * n == 11184824
