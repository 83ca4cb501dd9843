"""The port's BC4 and BC5 transforms and untransforms (plain versions,
``device="cpu"``) against the JAX package, byte for byte."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dxt_lossless_transform_tpu.ops import bc45 as jax_bc45
from dxt_lossless_transform_tpu.ops.pallas.shuffle import (
    bc4_transform_tpu, bc4_untransform_tpu, bc5_transform_tpu, bc5_untransform_tpu,
)
from dxt_lossless_transform_tpu.settings import (
    Bc4TransformSettings as Jax4, Bc5TransformSettings as Jax5,
)
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import Bc4ValidationError, Bc5ValidationError
from dxt_lossless_transform_tpu_torch.ops import bc45
from dxt_lossless_transform_tpu_torch.ops.cuda import shuffle

# format -> (block size, JAX transform, JAX untransform, port transform, port
# untransform, TPU kernels, kernel wrappers, settings)
FORMATS = {
    "BC4": (8, jax_bc45.transform_bc4, jax_bc45.untransform_bc4, bc45.transform_bc4,
            bc45.untransform_bc4, (bc4_transform_tpu, bc4_untransform_tpu),
            (shuffle.bc4_transform, shuffle.bc4_untransform),
            list(Jax4.all_combinations())),
    "BC5": (16, jax_bc45.transform_bc5, jax_bc45.untransform_bc5, bc45.transform_bc5,
            bc45.untransform_bc5, (bc5_transform_tpu, bc5_untransform_tpu),
            (shuffle.bc5_transform, shuffle.bc5_untransform),
            list(Jax5.all_combinations())),
}
CASES = [(fmt, split) for fmt in FORMATS for split in (True, False)]


def _data(n: int, block_size: int, kind: str) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 256, block_size * n, np.uint8).tobytes()
    # endpoints that vary slowly and a few index patterns, as in a real mask
    sections = np.empty((n * block_size // 8, 8), np.uint8)
    base = (128 + 100 * np.sin(np.linspace(0, 6, len(sections)))).astype(np.uint8)
    sections[:, 0] = base
    sections[:, 1] = base - rng.integers(0, 16, len(sections)).astype(np.uint8)
    sections[:, 2:] = rng.integers(0, 256, (4, 6), np.uint8)[
        rng.integers(0, 4, len(sections))]
    return sections.tobytes()


def _settings(fmt: str, split: bool):
    return (Jax4 if fmt == "BC4" else Jax5)(split)


# 70,000 BC5 blocks (1.12 MB) is above the JAX package's 1 MiB device threshold
@pytest.mark.parametrize("n", [1, 2, 3, 5, 2047, 2049, 70000])
@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("fmt,split", CASES)
def test_matches_jax(fmt, split, kind, n):
    bs, jax_t, jax_u, port_t, port_u, *_ = FORMATS[fmt]
    data = _data(n, bs, kind)
    settings = _settings(fmt, split)
    port = convert.from_reference(settings)
    want = jax_t(data, settings)
    got = port_t(data, port, device="cpu")
    assert got == want
    assert port_u(got, port, device="cpu") == data
    assert jax_u(got, settings) == data


@pytest.mark.parametrize("fmt,split", CASES)
def test_matches_pallas_kernels_interpret(fmt, split):
    """At n=2048 the streams also equal the TPU kernels' (interpret mode)."""
    bs, *_, (tpu_t, tpu_u), (port_t, port_u), _ = FORMATS[fmt]
    n = 2048
    data = _data(n, bs, "random")
    streams = tpu_t(jnp.asarray(np.frombuffer(data, "<u4")), split, interpret=True)
    want = b"".join(np.asarray(s).astype("<u4").tobytes() for s in streams)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    got = port_t(x, split)
    assert got.numpy().tobytes() == want
    tensor_form = bc45.transform_bc4_tensor if fmt == "BC4" else bc45.transform_bc5_tensor
    assert torch.equal(tensor_form(x, convert.from_reference(_settings(fmt, split))), got)
    back = tpu_u(streams, split, interpret=True)
    assert np.asarray(back).astype("<u4").tobytes() == data
    assert port_u(got, split).numpy().tobytes() == data


@pytest.mark.parametrize("length", [1, 7, 9, 15, 17, 4100])
@pytest.mark.parametrize("fmt", FORMATS)
def test_wrong_length_raises(fmt, length):
    bs, *_, port_t, port_u, _, _, _ = FORMATS[fmt]
    error = Bc4ValidationError if fmt == "BC4" else Bc5ValidationError
    if length % bs == 0:
        length += 1
    for fn in (port_t, port_u):
        with pytest.raises(error):
            fn(bytes(length), device="cpu")


@pytest.mark.parametrize("fmt", FORMATS)
def test_empty(fmt):
    *_, port_t, port_u, _, _, _ = FORMATS[fmt]
    assert port_t(b"", device="cpu") == b"" and port_u(b"", device="cpu") == b""


def test_stream_offsets_follow_the_oracle():
    """BC5 split: Ra0 at 0, Ra1 at n, Ga0 at 2n, Ga1 at 3n, red indices at 4n,
    green indices at 10n; BC4 interleaved: endpoints at 0, indices at 2n."""
    n = 3
    blocks = np.arange(16 * n, dtype=np.uint8).reshape(n, 16)
    out = np.frombuffer(bc45.transform_bc5(
        blocks.tobytes(), convert.from_reference(Jax5(True)), device="cpu"), np.uint8)
    for i, col in enumerate((0, 1, 8, 9)):
        np.testing.assert_array_equal(out[i * n:(i + 1) * n], blocks[:, col])
    np.testing.assert_array_equal(out[4 * n:10 * n], blocks[:, 2:8].reshape(-1))
    np.testing.assert_array_equal(out[10 * n:], blocks[:, 10:].reshape(-1))
    b4 = blocks.reshape(2 * n, 8)
    out = np.frombuffer(bc45.transform_bc4(
        b4.tobytes(), convert.from_reference(Jax4(False)), device="cpu"), np.uint8)
    np.testing.assert_array_equal(out[:4 * n], b4[:, :2].reshape(-1))
    np.testing.assert_array_equal(out[4 * n:], b4[:, 2:].reshape(-1))
