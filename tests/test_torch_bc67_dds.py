"""Whole BC7 and BC6H DX10 DDS files through the port's ``DdsHandler`` (plain
versions, ``"cpu"``) against the JAX package's handler: the same transformed bytes
with manual settings and with the LTU auto-search, restored exactly, and the same
errors for truncated files and payloads whose length fits no block count."""

import numpy as np
import pytest

from dxt_lossless_transform_tpu import api as jax_api
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.formats import handlers as jax_handlers
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle as JaxBundle
from dxt_lossless_transform_tpu.formats.embed import TransformHeader as JaxHeader
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import api
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.formats import errors, handlers
from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
from dxt_lossless_transform_tpu_torch.formats.embed import (
    TransformFormat, TransformHeader,
)
from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
from dxt_lossless_transform_tpu_torch.settings import (
    Bc6hTransformSettings, Bc7TransformSettings,
)
from dxt_lossless_transform_tpu_torch.utils import testgen

FORMATS = {"BC7": ("bc7", Bc7TransformSettings), "BC6H": ("bc6h", Bc6hTransformSettings)}
# (width, height, mips): odd block counts, a single block, a chain down to 1x1
SHAPES = [(64, 64, 7), (36, 20, 3), (4, 4, 1), (260, 132, 2)]


def _file(fmt: str, shape, kind: str, trailing: bytes = b"") -> bytes:
    w, h, mips = shape
    if kind == "realistic":
        return jax_testgen.make_dx10_dds(fmt, w, h, mips, seed=w + h, trailing=trailing)
    n = sum(max(1, (w >> i) // 4 + ((w >> i) % 4 > 0)) * max(1, (h >> i) // 4 +
            ((h >> i) % 4 > 0)) for i in range(mips))
    return jax_testgen.make_dx10_dds(fmt, w, h, mips, trailing=trailing,
                                     payload=jax_testgen.bc_blocks(n, 16, w * h))


def _builders(fmt: str):
    name = "Bc7" if fmt == "BC7" else "Bc6h"
    return (getattr(api, f"{name}ManualTransformBuilder"),
            getattr(api, f"{name}AutoTransformBuilder"),
            getattr(jax_api, f"{name}ManualTransformBuilder"),
            getattr(jax_api, f"{name}AutoTransformBuilder"))


@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("planes", [True, False])
@pytest.mark.parametrize("fmt", FORMATS)
def test_manual_files_match_jax(fmt, planes, sort, shape, kind):
    slot, _ = FORMATS[fmt]
    manual, _, jax_manual, _ = _builders(fmt)
    data = _file(fmt, shape, kind, trailing=b"tail")
    port = DdsHandler("cpu").transform_bundle(data, TransformBundle(
        **{slot: manual().sort_by_mode(sort).split_byte_planes(planes)}))
    jax = jax_handlers.DdsHandler().transform_bundle(data, JaxBundle(
        **{slot: jax_manual().sort_by_mode(sort).split_byte_planes(planes)}))
    assert port == jax
    assert DdsHandler("cpu").untransform(port) == data
    assert jax_handlers.DdsHandler().untransform(port) == data


@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("fmt", FORMATS)
def test_auto_files_match_jax(fmt, shape, kind):
    slot, _ = FORMATS[fmt]
    _, auto, _, jax_auto = _builders(fmt)
    data = _file(fmt, shape, kind)
    port = DdsHandler("cpu").transform_bundle(
        data, TransformBundle(**{slot: auto(LtuEstimation())}))
    jax = jax_handlers.DdsHandler().transform_bundle(
        data, JaxBundle(**{slot: jax_auto(JaxLtu())}))
    assert port == jax
    assert DdsHandler("cpu").untransform(port) == data


@pytest.mark.parametrize("fmt", FORMATS)
def test_mode_sorted_payload_is_longer_in_both_directions(fmt):
    """The repaired handler: a mode-sorted payload is ceil(n/2) bytes longer than the
    texture, which the transform's size check and the untransform's payload end
    both take from ``transformed_payload_len``; the trailing bytes stay behind it."""
    slot, cls = FORMATS[fmt]
    manual = _builders(fmt)[0]
    data = testgen.make_dx10_dds(fmt, 36, 20, 3, seed=5, trailing=b"trailing bytes")
    n = (len(data) - 0x94 - len(b"trailing bytes")) // 16
    out = DdsHandler("cpu").transform_bundle(data, TransformBundle(**{slot: manual()}))
    assert len(out) == len(data) + (n + 1) // 2
    assert out.endswith(b"trailing bytes")
    assert DdsHandler("cpu").untransform(out) == data
    for s in cls.all_combinations():
        header = getattr(TransformHeader, f"for_{slot}")(s)
        jax_header = JaxHeader.from_bytes(header.to_bytes())
        for length in (0, 16, 16 * n, 16 * 4097):
            assert handlers.transformed_payload_len(header, length) == \
                jax_handlers.transformed_payload_len(jax_header, length)


@pytest.mark.parametrize("fmt", FORMATS)
def test_truncated_transformed_file_raises_as_jax(fmt):
    slot = FORMATS[fmt][0]
    manual = _builders(fmt)[0]
    data = testgen.make_dx10_dds(fmt, 36, 20, 3, seed=5)
    out = DdsHandler("cpu").transform_bundle(data, TransformBundle(**{slot: manual()}))
    for cut in (1, 11, (len(out) - len(data)) + 1):
        with pytest.raises(errors.InputTooShortForStatedTextureSize):
            DdsHandler("cpu").untransform(out[:-cut])
        with pytest.raises(jax_handlers.InputTooShortForStatedTextureSize):
            jax_handlers.DdsHandler().untransform(out[:-cut])


@pytest.mark.parametrize("fmt", FORMATS)
def test_payload_fitting_no_block_count_raises_as_jax(fmt):
    slot, cls = FORMATS[fmt]
    for s in cls.all_combinations():
        header = getattr(TransformHeader, f"for_{slot}")(s)
        jax_header = JaxHeader.from_bytes(header.to_bytes())
        # 17 = 16 + 1 and 33 = 32 + 1 fit one and two blocks when sorting
        for length in (1, 15, 17, 18, 33, 35):
            payload = bytes(length)
            fits = length in ((17, 33) if s.sort_by_mode else ())
            if fits:
                assert handlers.dispatch_untransform(header, payload, "cpu") == \
                    jax_handlers.dispatch_untransform(jax_header, payload)
                continue
            with pytest.raises(errors.InvalidDataAlignment):
                handlers.dispatch_untransform(header, payload, "cpu")
            with pytest.raises(jax_handlers.InvalidDataAlignment):
                jax_handlers.dispatch_untransform(jax_header, payload)


@pytest.mark.parametrize("fmt", FORMATS)
def test_header_round_trip_matches_jax(fmt):
    slot, cls = FORMATS[fmt]
    for s in cls.all_combinations():
        header = getattr(TransformHeader, f"for_{slot}")(s)
        jax_settings = getattr(JaxHeader.from_bytes(header.to_bytes()),
                               f"{slot}_settings")()
        assert (jax_settings.sort_by_mode, jax_settings.split_byte_planes) == \
            (s.sort_by_mode, s.split_byte_planes)
        assert getattr(header, f"{slot}_settings")() == s
        assert header.format == TransformFormat[fmt]
    bad = TransformHeader(TransformFormat[fmt], 0x1)
    with pytest.raises(errors.CorruptedEmbeddedData):
        getattr(bad, f"{slot}_settings")()


@pytest.mark.parametrize("fmt", FORMATS)
def test_bundle_without_the_builder_raises(fmt):
    data = testgen.make_dx10_dds(fmt, 8, 8)
    with pytest.raises(errors.NoBuilderForFormat) as info:
        DdsHandler("cpu").transform_bundle(data, TransformBundle(
            bc1=api.Bc1ManualTransformBuilder()))
    assert "later slice" not in str(info.value)


def test_rgb_is_still_a_later_slice():
    """The RGB formats came with a later slice: a JAX-written RGBA8888 file now
    untransforms in the port to the JAX package's bytes."""
    data = jax_testgen.make_uncompressed_dds("rgba8888", 8, 8)
    jax_out = jax_handlers.DdsHandler().transform_bundle(
        data, JaxBundle(rgba8888=jax_api.RgbManualTransformBuilder("rgba8888")))
    assert DdsHandler("cpu").untransform(jax_out) == \
        jax_handlers.DdsHandler().untransform(jax_out) == data
    assert np.frombuffer(jax_out[:4], "<u4")[0] & 0xF == TransformFormat.RGBA8888
