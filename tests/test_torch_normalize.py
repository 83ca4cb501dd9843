"""The port's block normalization and normalize-then-auto search against the JAX
package's (``oracle/normalize.py``, ``ops/normalize.py``), on the CPU, byte for byte
(tolerance 0), on seeded blocks with the blocks that normalization rewrites mixed in
(``chip_smoke.normalizable``)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu import settings as jax_settings_module
from dxt_lossless_transform_tpu.estimate.ltu import LtuEstimation as JaxLtu
from dxt_lossless_transform_tpu.ops import normalize as jax_ops_norm
from dxt_lossless_transform_tpu.oracle import bc1 as jax_bc1, bc2 as jax_bc2
from dxt_lossless_transform_tpu.oracle import bc3 as jax_bc3
from dxt_lossless_transform_tpu.oracle import normalize as jax_norm
from dxt_lossless_transform_tpu.utils import testgen
from dxt_lossless_transform_tpu_torch.errors import AutoTransformError
from dxt_lossless_transform_tpu_torch.estimate import LtuEstimation, ZstdEstimation
from dxt_lossless_transform_tpu_torch.ops import bc1, bc2, bc3, decode
from dxt_lossless_transform_tpu_torch.ops import normalize as norm
from dxt_lossless_transform_tpu_torch.oracle import decode as odecode
from dxt_lossless_transform_tpu_torch.settings import (
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CM, AM = norm.ColorNormalizationMode, norm.AlphaNormalizationMode
REALISTIC = {"BC1": testgen.bc1_realistic, "BC2": testgen.bc2_realistic,
             "BC3": testgen.bc3_realistic}
BC3_GRID = [(am, cm) for am in AM.all_values() for cm in CM.all_values()]


def mixed(fmt: str, n: int = 1000, seed: int = 3) -> bytes:
    return chip_smoke.normalizable(fmt, REALISTIC[fmt](n, seed), seed)


def test_enums_keep_their_names_and_values():
    assert [(m.name, int(m)) for m in CM] == \
        [(m.name, int(m)) for m in jax_norm.ColorNormalizationMode]
    assert [(m.name, int(m)) for m in AM] == \
        [(m.name, int(m)) for m in jax_norm.AlphaNormalizationMode]
    assert CM.all_values() == tuple(CM) and AM.all_values() == tuple(AM)


@pytest.mark.parametrize("mode", list(CM))
@pytest.mark.parametrize("fmt", ["bc1", "bc2"])
def test_normalize_blocks_matches_jax(fmt, mode):
    data = mixed(fmt.upper())
    got = getattr(norm, f"normalize_blocks_{fmt}")(data, mode, device="cpu")
    assert got == getattr(jax_norm, f"normalize_blocks_{fmt}")(data, int(mode))
    # visually lossless: the same pixels as the original
    dec = getattr(odecode, f"decode_{fmt}")
    np.testing.assert_array_equal(dec(got), dec(data))
    changed = (np.frombuffer(got, np.uint8) != np.frombuffer(data, np.uint8)).sum()
    assert (changed == 0) == (mode == CM.NONE)


@pytest.mark.parametrize("amode,cmode", BC3_GRID)
def test_normalize_blocks_bc3_matches_jax(amode, cmode):
    data = mixed("BC3")
    got = norm.normalize_blocks_bc3(data, amode, cmode, device="cpu")
    assert got == jax_norm.normalize_blocks_bc3(data, int(amode), int(cmode))
    np.testing.assert_array_equal(odecode.decode_bc3(got), odecode.decode_bc3(data))
    changed = (np.frombuffer(got, np.uint8) != np.frombuffer(data, np.uint8)).sum()
    assert (changed == 0) == (amode == AM.NONE and cmode == CM.NONE)


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_all_modes_match_jax(fmt):
    data = mixed(fmt.upper(), 600, 9)
    got = getattr(norm, f"normalize_blocks_all_modes_{fmt}")(data, device="cpu")
    want = getattr(jax_norm, f"normalize_blocks_all_modes_{fmt}")(data)
    as_ints = (lambda k: tuple(map(int, k))) if fmt == "bc3" else int
    assert {as_ints(k): v for k, v in got.items()} == \
        {as_ints(k): v for k, v in want.items()}


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("mode", list(CM))
def test_split_in_place_bc1_matches_jax(mode):
    colors, indices = jax_bc1.split_blocks(mixed("BC1"))
    c, i = _i32(colors), _i32(indices)
    jax_norm.normalize_split_blocks_in_place_bc1(colors, indices, int(mode))
    norm.normalize_split_blocks_in_place_bc1(c, i, mode)
    np.testing.assert_array_equal(c.numpy().view(np.uint32), colors)
    np.testing.assert_array_equal(i.numpy().view(np.uint32), indices)


@pytest.mark.parametrize("mode", list(CM))
def test_split_in_place_bc2_matches_jax(mode):
    alpha, colors, indices = jax_bc2.split_blocks(mixed("BC2"))
    a = torch.from_numpy(alpha.view(np.int64).copy())
    c, i = _i32(colors), _i32(indices)
    jax_norm.normalize_split_blocks_in_place_bc2(alpha, colors, indices, int(mode))
    norm.normalize_split_blocks_in_place_bc2(a, c, i, mode)
    np.testing.assert_array_equal(a.numpy().view(np.uint64), alpha)
    np.testing.assert_array_equal(c.numpy().view(np.uint32), colors)
    np.testing.assert_array_equal(i.numpy().view(np.uint32), indices)


@pytest.mark.parametrize("amode,cmode", BC3_GRID)
def test_split_in_place_bc3_matches_jax(amode, cmode):
    ep, idx, colors, cidx = jax_bc3.split_blocks(mixed("BC3", 500, 4))
    t_ep = torch.from_numpy(ep.astype(np.int32))
    t_idx = torch.from_numpy(idx.astype(np.int32))
    c, ci = _i32(colors), _i32(cidx)
    jax_norm.normalize_split_blocks_in_place_bc3(ep, idx, colors, cidx, int(amode),
                                                 int(cmode))
    norm.normalize_split_blocks_in_place_bc3(t_ep, t_idx, c, ci, amode, cmode)
    np.testing.assert_array_equal(t_ep.numpy(), ep)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(c.numpy().view(np.uint32), colors)
    np.testing.assert_array_equal(ci.numpy().view(np.uint32), cidx)


def test_bc1_canonical_patterns():
    transparent = bytes([0x00, 0x00, 0xFF, 0xFF]) + b"\xFF" * 4
    assert norm.normalize_blocks_bc1(transparent, CM.COLOR0_ONLY, "cpu") == b"\xFF" * 8
    solid = bytes([0x00, 0xF8, 0x00, 0xF8, 0, 0, 0, 0])
    assert norm.normalize_blocks_bc1(solid, CM.COLOR0_ONLY, "cpu") == \
        bytes([0x00, 0xF8, 0x00, 0x00, 0, 0, 0, 0])
    assert norm.normalize_blocks_bc1(solid, CM.REPLICATE_COLOR, "cpu") == solid


def test_bc3_alpha_canonical_patterns():
    color = bytes([0x00, 0xF8, 0x00, 0xF8, 0, 0, 0, 0])
    opaque = bytes([255, 255]) + bytes(6) + color
    out = norm.normalize_blocks_bc3(opaque, AM.OPAQUE_FILL_ALL, CM.NONE, "cpu")
    assert out[:8] == b"\xFF" * 8
    out = norm.normalize_blocks_bc3(opaque, AM.OPAQUE_ZERO_ALPHA_MAX_INDICES, CM.NONE,
                                    "cpu")
    assert out[:8] == bytes([0, 0]) + b"\xFF" * 6
    half = bytes([128, 128]) + bytes(6) + color
    out = norm.normalize_blocks_bc3(half, AM.OPAQUE_FILL_ALL, CM.NONE, "cpu")
    assert out[:8] == bytes([128, 0, 0, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_words_entry_points_match_the_bytes(fmt):
    data = mixed(fmt.upper(), 300, 5)
    cols = 2 if fmt == "bc1" else 4
    w = decode.words(torch.frombuffer(bytearray(data), dtype=torch.uint8), cols)
    modes = (AM.OPAQUE_FILL_ALL, CM.REPLICATE_COLOR) if fmt == "bc3" \
        else (CM.REPLICATE_COLOR,)
    got = getattr(norm, f"normalize_words_{fmt}")(w, *modes)
    assert got.numpy().tobytes() == getattr(norm, f"normalize_blocks_{fmt}")(
        data, *modes, device="cpu")
    assert got.data_ptr() != w.data_ptr()


SETTINGS = {"bc1": Bc1TransformSettings, "bc2": Bc2TransformSettings,
            "bc3": Bc3TransformSettings}


def _same(port_result, jax_result):
    assert port_result[0] == jax_result[0]
    assert str(port_result[1]) == str(jax_result[1])
    assert [int(m) for m in port_result[2:]] == [int(m) for m in jax_result[2:]]


@pytest.mark.parametrize("use_all", [False, True], ids=["fast", "comprehensive"])
@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_auto_with_normalization_matches_jax(fmt, use_all):
    """Below 2**24 JAX's f32 scores are exact, so the picks must agree."""
    data = mixed(fmt.upper(), 3000, 5)
    got = getattr(norm, f"transform_{fmt}_auto_with_normalization")(
        data, LtuEstimation(), use_all, device="cpu")
    want = getattr(jax_ops_norm, f"transform_{fmt}_auto_with_normalization")(
        data, JaxLtu(), use_all)
    _same(got, want)
    # the untransform gives the normalized payload back
    settings, modes = got[1], got[2:]
    normalized = getattr(norm, f"normalize_blocks_{fmt}")(data, *modes, device="cpu")
    assert {"bc1": bc1, "bc2": bc2, "bc3": bc3}[fmt].untransform(
        got[0], settings, device="cpu") == normalized


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_auto_with_normalization_mode_subsets_match_jax(fmt):
    data = mixed(fmt.upper(), 800, 6)
    if fmt == "bc3":
        kw = dict(alpha_modes=[AM.OPAQUE_ZERO_ALPHA_MAX_INDICES, AM.NONE],
                  color_modes=[CM.REPLICATE_COLOR])
    else:
        kw = dict(color_modes=[CM.REPLICATE_COLOR, CM.NONE])
    jkw = {k: [int(m) for m in v] for k, v in kw.items()}
    got = getattr(norm, f"transform_{fmt}_auto_with_normalization")(
        data, LtuEstimation(), device="cpu", **kw)
    want = getattr(jax_ops_norm, f"transform_{fmt}_auto_with_normalization")(
        data, JaxLtu(), **jkw)
    _same(got, want)


def test_auto_with_normalization_zstd_round_trip():
    try:
        est = ZstdEstimation(1)
        est.estimate(b"x")
    except Exception as exc:  # the system zstd library is the port's only zstd
        pytest.fail(f"zstd unavailable: {exc!r}")
    data = mixed("BC1", 1024, 8)
    out, settings, mode = norm.transform_bc1_auto_with_normalization(data, est,
                                                                     device="cpu")
    assert bc1.untransform(out, settings, device="cpu") == \
        norm.normalize_blocks_bc1(data, mode, device="cpu")


@pytest.mark.parametrize("mode", list(CM))
@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_transform_with_normalize_blocks_matches_jax(fmt, mode):
    data = mixed(fmt.upper(), 400, 7)
    jax_settings = getattr(jax_settings_module, f"{fmt.capitalize()}TransformSettings")
    for s in list(SETTINGS[fmt].all_combinations())[::3]:
        js = jax_settings(**{k: getattr(s, k) for k in s.__dataclass_fields__})
        modes = (AM.UNIFORM_ALPHA_ZERO_INDICES, mode) if fmt == "bc3" else (mode,)
        got = getattr(norm, f"transform_{fmt}_with_normalize_blocks")(
            data, s, *modes, device="cpu")
        assert got == getattr(jax_ops_norm, f"transform_{fmt}_with_normalize_blocks")(
            data, js, *map(int, modes))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # compared by kind with the JAX package's
        return ("raises", exc)


@pytest.mark.parametrize("length", [0, 4, 8, 12, 16, 20, 24, 40])
@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_empty_short_and_unaligned_inputs_match_jax(fmt, length):
    data = (mixed(fmt.upper(), 3, 1) + bytes(range(64)))[:length]
    modes = (AM.OPAQUE_FILL_ALL, CM.COLOR0_ONLY) if fmt == "bc3" else (CM.COLOR0_ONLY,)
    cases = [
        (lambda: getattr(norm, f"normalize_blocks_{fmt}")(data, *modes, device="cpu"),
         lambda: getattr(jax_norm, f"normalize_blocks_{fmt}")(data, *map(int, modes))),
        (lambda: getattr(norm, f"transform_{fmt}_auto_with_normalization")(
            data, LtuEstimation(), device="cpu"),
         lambda: getattr(jax_ops_norm, f"transform_{fmt}_auto_with_normalization")(
            data, JaxLtu())),
    ]
    for port_fn, jax_fn in cases:
        got, want = _outcome(port_fn), _outcome(jax_fn)
        assert got[0] == want[0], (got, want)
        if got[0] == "raises":
            # the same kind: ValueError, or the auto-search's RuntimeError
            assert isinstance(got[1], ValueError) == isinstance(want[1], ValueError)
            assert isinstance(got[1], RuntimeError) == isinstance(want[1], RuntimeError)
            if isinstance(want[1], RuntimeError):
                assert isinstance(got[1], AutoTransformError)
        elif isinstance(want[1], tuple):
            _same(got[1], want[1])
        else:
            assert got[1] == want[1]
    # NONE takes any length, as in JAX
    none = (AM.NONE, CM.NONE) if fmt == "bc3" else (CM.NONE,)
    assert getattr(norm, f"normalize_blocks_{fmt}")(data, *none, device="cpu") == data
