"""The port's BC7 and BC6H auto-searches (plain versions, ``device="cpu"``) against
the JAX package: exact integer scores of each candidate's whole stream, picks, the
zstd-1 identity guard's decision both ways, and the shipped bytes."""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu import runtime
from dxt_lossless_transform_tpu.estimate.base import NoEstimation as JaxNoEstimation
from dxt_lossless_transform_tpu.estimate.ltu import (
    DEFAULT_OFFSETS, LtuEstimation as JaxLtu, _coverage_score_np,
)
from dxt_lossless_transform_tpu.estimate.zstd import ZstdEstimation as JaxZstd
from dxt_lossless_transform_tpu.ops import bc6h as jax_bc6h, bc7 as jax_bc7
from dxt_lossless_transform_tpu.oracle import bc6h as oracle_bc6h, bc7 as oracle_bc7
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.api import (
    Bc6hAutoTransformBuilder, Bc7AutoTransformBuilder,
)
from dxt_lossless_transform_tpu_torch.errors import (
    AutoTransformError, Bc6hValidationError, Bc7ValidationError, ZstdUnavailableError,
)
from dxt_lossless_transform_tpu_torch.estimate import zstd
from dxt_lossless_transform_tpu_torch.estimate.base import NoEstimation, SizeEstimation
from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
from dxt_lossless_transform_tpu_torch.ops import bc6h, bc7
from dxt_lossless_transform_tpu_torch.settings import (
    BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, Bc6hTransformSettings,
    Bc7TransformSettings,
)

# format -> (port search, JAX search, JAX oracle, port fmt id, candidates, settings)
FORMATS = {
    "BC7": (bc7.transform_bc7_auto, jax_bc7.transform_bc7_auto, oracle_bc7, bc7.BC7,
            BC7_FAST_CANDIDATES, Bc7TransformSettings),
    "BC6H": (bc6h.transform_bc6h_auto, jax_bc6h.transform_bc6h_auto, oracle_bc6h,
             bc7.BC6H, BC6H_FAST_CANDIDATES, Bc6hTransformSettings),
}


def _data(n: int, kind: str) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "realistic":
        return jax_testgen.bc7_realistic(n, n)
    if kind == "random":
        return rng.integers(0, 256, 16 * n, np.uint8).tobytes()
    # modes in runs, payload bytes near one base: sorting and planes both help
    blocks = (rng.integers(0, 8, (n, 16)) + 100).astype(np.uint8)
    blocks[:, 0] = np.repeat(rng.integers(0, 256, n // 64 + 1), 64)[:n]
    return blocks.tobytes()


def _exact_scores(fmt: str, data: bytes) -> list:
    oracle, cand = FORMATS[fmt][2], FORMATS[fmt][4]
    return [runtime.ltu_estimate(oracle.transform(data, convert.to_reference(c, _jax())))
            for c in cand]


def _jax():
    from dxt_lossless_transform_tpu import settings

    return settings


KINDS = ["realistic", "random", "runs"]


@pytest.mark.parametrize("n", [1, 3, 300, 4097, 9000])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_auto_matches_jax(fmt, kind, n):
    port_search, jax_search = FORMATS[fmt][:2]
    data = _data(n, kind)
    out, settings = port_search(data, LtuEstimation(), device="cpu")
    jax_out, jax_settings = jax_search(data, JaxLtu())
    assert out == jax_out
    assert settings == convert.from_reference(jax_settings)


@pytest.mark.parametrize("n", [1, 300, 4097])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_scores_are_the_exact_twins(fmt, kind, n):
    """Each candidate's score is the exact integer score of its whole on-disk stream:
    the native twin's, and the numpy twin's."""
    _, _, oracle, fmt_id, cand, _ = FORMATS[fmt]
    data = _data(n, kind)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    scores, streams = bc7.candidate_streams(x, fmt_id, LtuEstimation(), cand, fmt)
    assert scores.tolist() == _exact_scores(fmt, data)
    for c in cand:
        stream = oracle.transform(data, convert.to_reference(c, _jax()))
        assert streams[c.sort_by_mode, c.split_byte_planes].numpy().tobytes() == stream
        assert _coverage_score_np(np.frombuffer(stream, np.uint8), DEFAULT_OFFSETS) == \
            scores[cand.index(c)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_guard_matches_jax(fmt, kind):
    """The guard on each candidate's output: it keeps a winner that zstd-1 makes
    strictly smaller than the payload and ships the payload otherwise, as JAX's."""
    _, _, oracle, _, cand, _ = FORMATS[fmt]
    data = _data(5000, kind)
    for c in cand:
        out = oracle.transform(data, convert.to_reference(c, _jax()))
        got = bc7.ltu_identity_guard(data, out, c, cand)
        want_out, want_settings = jax_bc7.ltu_identity_guard(
            data, out, convert.to_reference(c, _jax()),
            tuple(convert.to_reference(s, _jax()) for s in cand))
        assert got == (want_out, convert.from_reference(want_settings))


def test_guard_decides_both_ways():
    cand = BC7_FAST_CANDIDATES
    full = Bc7TransformSettings(True, True)
    real = _data(5000, "realistic")
    out = bc7.transform(real, full, device="cpu")
    assert bc7.ltu_identity_guard(real, out, full, cand) == (out, full)  # kept
    rand = _data(5000, "random")
    out = bc7.transform(rand, full, device="cpu")
    assert bc7.ltu_identity_guard(rand, out, full, cand) == \
        (rand, Bc7TransformSettings(False, False))  # flipped
    # without the identity among the candidates, or with identity picked: no guard
    assert bc7.ltu_identity_guard(rand, out, full, cand[1:]) == (out, full)
    assert bc7.ltu_identity_guard(rand, rand, cand[0], cand) == (rand, cand[0])


# Block 0 of the flip test's data is all 0xEE and block 1 starts with 0x11, so only
# the planes-only stream starts with 0xEE, 0x11.
class _FavourPlanes(LtuEstimation):
    """An LTU estimator that ranks the planes-only layout first, so that the guard
    must flip the pick on incompressible data."""

    def estimate_batch_device(self, regions, valid_len):
        scores = super().estimate_batch_device(regions, valid_len)
        planes = (regions[:, 0] == 0xEE) & (regions[:, 1] == 0x11)
        return scores - torch.where(planes, 10**9, 0)


class _JaxFavourPlanes(JaxLtu):
    def estimate_batch(self, regions):
        return [self.estimate(r) - (10**9 if (r[0], r[1]) == (0xEE, 0x11) else 0)
                for r in regions]


@pytest.mark.parametrize("fmt", FORMATS)
def test_guard_flips_the_search_as_jax(fmt):
    """Through the search: a planes-only winner that zstd-1 does not make smaller is
    shipped as the identity, by the port and by the JAX package alike."""
    port_search, jax_search, oracle, _, cand, cls = FORMATS[fmt]
    blocks = np.frombuffer(_data(3000, "random"), np.uint8).reshape(-1, 16).copy()
    blocks[0, :] = 0xEE
    blocks[1, 0] = 0x11
    data = blocks.tobytes()
    out, settings = port_search(data, _FavourPlanes(), device="cpu")
    jax_out, jax_settings = jax_search(data, _JaxFavourPlanes())
    assert (out, settings) == (data, cls(False, False))
    assert jax_out == data and convert.from_reference(jax_settings) == settings
    # the same search without the guard ships the planes layout
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    scores, _ = bc7.candidate_streams(x, FORMATS[fmt][3], _FavourPlanes(), cand, fmt)
    assert cand[int(np.argmin(scores))] == cls(False, True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_missing_zstd_is_an_auto_transform_error(fmt, monkeypatch):
    port_search = FORMATS[fmt][0]

    def missing():
        raise ZstdUnavailableError(zstd.LIBRARY, "not found")

    monkeypatch.setattr(zstd, "load_library", missing)
    data = _data(300, "realistic")  # the LTU winner is not the identity
    with pytest.raises(AutoTransformError, match="libzstd.so.1"):
        port_search(data, LtuEstimation(), device="cpu")
    # other estimators need no guard, and so no zstd
    assert port_search(data, NoEstimation(), device="cpu")[1] == FORMATS[fmt][4][0]


class _Length(SizeEstimation):
    """A host-only estimator: the number of distinct 16-byte blocks."""

    def estimate(self, data):
        return len(set(bytes(data)[i:i + 16] for i in range(0, len(data), 16)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_other_estimators_pick_as_jax_without_the_guard(fmt):
    from dxt_lossless_transform_tpu.estimate.base import SizeEstimation as JaxBase

    class JaxLength(JaxBase):
        estimate = _Length.estimate

    port_search, jax_search = FORMATS[fmt][:2]
    for kind in KINDS:
        data = _data(1500, kind)
        for port_est, jax_est in ((NoEstimation(), JaxNoEstimation()),
                                  (zstd.ZstdEstimation(1), JaxZstd(1)),
                                  (_Length(), JaxLength())):
            out, settings = port_search(data, port_est, device="cpu")
            jax_out, jax_settings = jax_search(data, jax_est)
            assert out == jax_out and settings == convert.from_reference(jax_settings)


@pytest.mark.parametrize("fmt", FORMATS)
def test_candidate_lists_as_jax(fmt):
    port_search, jax_search, _, _, cand, cls = FORMATS[fmt]
    data = _data(2000, "runs")
    for chosen in ((cls(True, False),), (cls(False, True), cls(True, True)),
                   cand + cand, (cls(False, False),)):
        jax_cand = tuple(convert.to_reference(c, _jax()) for c in chosen)
        out, settings = port_search(data, LtuEstimation(), candidates=chosen,
                                    device="cpu")
        jax_out, jax_settings = jax_search(data, JaxLtu(), candidates=jax_cand)
        assert out == jax_out and settings == convert.from_reference(jax_settings)


@pytest.mark.parametrize("fmt", FORMATS)
def test_short_and_unaligned_inputs(fmt):
    port_search, jax_search, _, _, cand, _ = FORMATS[fmt]
    error = Bc7ValidationError if fmt == "BC7" else Bc6hValidationError
    assert port_search(b"", LtuEstimation(), device="cpu") == (b"", cand[-1])
    assert jax_search(b"", JaxLtu())[0] == b""
    for size in (1, 15, 17, 33):
        with pytest.raises(error):
            port_search(bytes(size), LtuEstimation(), device="cpu")
        with pytest.raises(ValueError):  # JAX's validation error
            jax_search(bytes(size), JaxLtu())


@pytest.mark.parametrize("builder", [Bc7AutoTransformBuilder, Bc6hAutoTransformBuilder])
def test_auto_builder_returns_the_untransform_recipe(builder):
    data = _data(777, "realistic")
    out, manual = builder(LtuEstimation()).transform(data, device="cpu")
    assert manual.untransform(out, device="cpu") == data
    ultra, _ = builder.new_ultra(LtuEstimation()).transform(data, device="cpu")
    assert ultra == out  # one candidate set
