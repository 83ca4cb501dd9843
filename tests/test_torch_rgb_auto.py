"""The port's RGB auto-search and builders (plain versions, ``device="cpu"``) against
the JAX package's under the LTU estimator: exact integer scores of each candidate's
whole stream, picks, shipped bytes, ties, and the edge cases' results and errors;
and the settings and builders through ``convert``."""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu import api as jax_api, errors as jax_errors
from dxt_lossless_transform_tpu import settings as jax_settings
from dxt_lossless_transform_tpu.estimate.base import NoEstimation as JaxNoEstimation
from dxt_lossless_transform_tpu.estimate.base import SizeEstimation as JaxSizeEstimation
from dxt_lossless_transform_tpu.estimate.ltu import (
    DEFAULT_OFFSETS, LtuEstimation as JaxLtu, _coverage_score_np,
)
from dxt_lossless_transform_tpu.ops import rgb as jax_rgb
from dxt_lossless_transform_tpu.oracle import rgb as oracle_rgb
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import convert, settings
from dxt_lossless_transform_tpu_torch.api import (
    RgbAutoTransformBuilder, RgbManualTransformBuilder,
)
from dxt_lossless_transform_tpu_torch.errors import RgbValidationError
from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.ops import rgb
from dxt_lossless_transform_tpu_torch.settings import (
    RGB_FAST_CANDIDATES, RgbTransformSettings,
)

LAYOUTS = tuple(rgb.LAYOUTS)
KINDS = ("gradient", "random", "zeros")


def _payload(layout: str, kind: str, w: int = 40, h: int = 24) -> bytes:
    stride = rgb.LAYOUTS[layout][0]
    if kind == "gradient":
        return jax_testgen.make_uncompressed_dds(layout, w, h, seed=w + h)[0x80:]
    if kind == "zeros":  # every candidate's stream is the same: a four-way tie
        return bytes(stride * w * h)
    return np.random.default_rng(w * h).integers(0, 256, stride * w * h,
                                                 np.uint8).tobytes()


def _key(s) -> tuple:
    return (s.decorrelate, s.split_channels)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_auto_matches_jax(layout, kind):
    data = _payload(layout, kind)
    out, pick = rgb.transform_rgb_auto(data, layout, LtuEstimation(), device="cpu")
    jax_out, jax_pick = jax_rgb.transform_rgb_auto(data, layout, JaxLtu())
    assert out == jax_out
    assert _key(pick) == _key(jax_pick)
    assert rgb.untransform(out, layout, pick, device="cpu") == data
    if kind == "zeros":
        assert pick == RGB_FAST_CANDIDATES[0]  # ties go to the first candidate


@pytest.mark.parametrize("layout", LAYOUTS)
def test_candidate_scores_are_exact(layout):
    data = _payload(layout, "gradient", 64, 48)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    scores, rows = rgb.candidate_rows(x, layout, LtuEstimation(), RGB_FAST_CANDIDATES)
    want = [_coverage_score_np(np.frombuffer(oracle_rgb.transform(
        data, layout, jax_settings.RgbTransformSettings(*_key(c))), np.uint8),
        DEFAULT_OFFSETS) for c in RGB_FAST_CANDIDATES]
    assert scores.tolist() == want
    assert JaxLtu().estimate_batch([rows[_key(c)].numpy().tobytes()
                                    for c in RGB_FAST_CANDIDATES]) == want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_builders_match_jax(layout):
    data = _payload(layout, "gradient", 32, 32)
    out, manual = RgbAutoTransformBuilder(layout, LtuEstimation()).transform(
        data, device="cpu")
    jax_out, jax_manual = jax_api.RgbAutoTransformBuilder(layout, JaxLtu()).transform(data)
    assert out == jax_out
    assert manual.layout == jax_manual.layout == layout
    assert _key(manual.get_settings()) == _key(jax_manual.get_settings())
    assert manual.untransform(out, device="cpu") == data
    ultra = RgbAutoTransformBuilder.new_ultra(layout, LtuEstimation())
    assert ultra.transform(data, device="cpu")[0] == out  # use_all changes nothing


@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_cases_as_jax(layout):
    stride = rgb.LAYOUTS[layout][0]
    assert rgb.transform_rgb_auto(b"", layout, LtuEstimation(), device="cpu") == \
        (b"", RGB_FAST_CANDIDATES[-1])
    out, pick = jax_rgb.transform_rgb_auto(b"", layout, JaxLtu())
    assert out == b"" and _key(pick) == _key(RGB_FAST_CANDIDATES[-1])
    # shorter than one pixel, and longer but not a whole number of pixels
    for length in list(range(1, stride)) + [stride + 1, 5 * stride + stride - 1]:
        with pytest.raises(RgbValidationError) as port:
            rgb.transform_rgb_auto(bytes(length), layout, LtuEstimation(), device="cpu")
        with pytest.raises(jax_errors.RgbValidationError) as jax:
            jax_rgb.transform_rgb_auto(bytes(length), layout, JaxLtu())
        assert str(port.value) == str(jax.value)
    one = bytes(range(stride))
    assert rgb.transform_rgb_auto(one, layout, LtuEstimation(), device="cpu")[0] == \
        jax_rgb.transform_rgb_auto(one, layout, JaxLtu())[0]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_candidates_and_estimators_as_jax(layout):
    data = _payload(layout, "gradient")
    # ties between repeated candidates go to the first
    cand = (RgbTransformSettings(True, True), RgbTransformSettings(False, True),
            RgbTransformSettings(True, True))
    jax_cand = tuple(jax_settings.RgbTransformSettings(*_key(c)) for c in cand)
    out, pick = rgb.transform_rgb_auto(data, layout, LtuEstimation(), candidates=cand,
                                       device="cpu")
    jax_out, jax_pick = jax_rgb.transform_rgb_auto(data, layout, JaxLtu(),
                                                   candidates=jax_cand)
    assert (out, _key(pick)) == (jax_out, _key(jax_pick))
    # NoEstimation scores every candidate 0: the identity, first, wins
    out, pick = rgb.transform_rgb_auto(data, layout, NoEstimation(), device="cpu")
    assert (out, pick) == (data, RGB_FAST_CANDIDATES[0])
    assert jax_rgb.transform_rgb_auto(data, layout, JaxNoEstimation())[0] == data


def test_an_estimators_error_is_not_wrapped_as_in_jax():
    class Boom(SizeEstimation):
        def estimate(self, data):
            raise KeyError("boom")

    class JaxBoom(JaxSizeEstimation):
        def estimate(self, data):
            raise KeyError("boom")

    data = _payload("rgba8888", "random")
    with pytest.raises(KeyError):
        rgb.transform_rgb_auto(data, "rgba8888", Boom(), device="cpu")
    with pytest.raises(KeyError):
        jax_rgb.transform_rgb_auto(data, "rgba8888", JaxBoom())


def test_manual_builder_as_jax():
    port = RgbManualTransformBuilder("bgr888")
    jax = jax_api.RgbManualTransformBuilder("bgr888")
    assert _key(port.get_settings()) == _key(jax.get_settings()) == (True, True)
    for step in (("decorrelate", False), ("split_channels", False),
                 ("decorrelate", True)):
        assert getattr(port, step[0])(step[1]) is port
        getattr(jax, step[0])(step[1])
        assert _key(port.get_settings()) == _key(jax.get_settings())
    data = _payload("bgr888", "gradient")
    assert port.transform(data, device="cpu") == jax.transform(data)
    for cls, jax_cls in ((RgbManualTransformBuilder, jax_api.RgbManualTransformBuilder),
                         (RgbAutoTransformBuilder, jax_api.RgbAutoTransformBuilder)):
        with pytest.raises(ValueError, match="unknown pixel layout"):
            cls("rgb565")
        with pytest.raises(ValueError, match="unknown pixel layout"):
            jax_cls("rgb565")


def test_settings_as_jax():
    assert settings.RGB_FAST_CANDIDATES == convert.from_reference(
        jax_settings.RGB_FAST_CANDIDATES)
    assert list(RgbTransformSettings.all_combinations()) == [
        convert.from_reference(s)
        for s in jax_settings.RgbTransformSettings.all_combinations()]
    assert RgbTransformSettings() == convert.from_reference(
        jax_settings.RgbTransformSettings())
    for s in RgbTransformSettings.all_combinations():
        assert convert.to_reference(s, jax_settings) == \
            jax_settings.RgbTransformSettings(*_key(s))


def test_convert_builders():
    manual = convert.from_reference(jax_api.RgbManualTransformBuilder(
        "bgra8888", jax_settings.RgbTransformSettings(False, True)))
    assert isinstance(manual, RgbManualTransformBuilder)
    assert (manual.layout, manual.get_settings()) == \
        ("bgra8888", RgbTransformSettings(False, True))
    auto = convert.from_reference(jax_api.RgbAutoTransformBuilder.new_ultra(
        "bgr888", JaxLtu((1, 2, 4))))
    assert isinstance(auto, RgbAutoTransformBuilder)
    assert auto.layout == "bgr888" and auto._use_all
    assert isinstance(auto._estimator, LtuEstimation)
    assert auto._estimator.offsets == (1, 2, 4)
