"""The port's BC1-BC3 decoders, colour helpers, MSB bit helpers and block extraction
against the JAX package's, on the CPU, byte for byte (tolerance 0)."""

import numpy as np
import pytest
import torch

from dxt_lossless_transform_tpu.formats import debug as jax_debug
from dxt_lossless_transform_tpu.ops import bc7 as jax_bc7, decode as jax_ddecode
from dxt_lossless_transform_tpu.oracle import color565 as jax_color565
from dxt_lossless_transform_tpu.oracle import decode as jax_odecode
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch.formats import debug
from dxt_lossless_transform_tpu_torch.formats.embed import TransformFormat
from dxt_lossless_transform_tpu_torch.ops import bc7, decode
from dxt_lossless_transform_tpu_torch.utils import testgen

COLS = {"bc1": 2, "bc2": 4, "bc3": 4}
REALISTIC = {"bc1": jax_testgen.bc1_realistic, "bc2": jax_testgen.bc2_realistic,
             "bc3": jax_testgen.bc3_realistic}


def _rgba(planes) -> np.ndarray:
    """(4, N, 16) planes -> (N, 4, 4, 4) uint8 pixels, the oracle's shape."""
    return np.moveaxis(np.asarray(planes), 0, -1).reshape(-1, 4, 4, 4).astype(np.uint8)


@pytest.mark.parametrize("kind", ["realistic", "random"])
@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_decode_matches_jax_and_oracle(fmt, kind):
    import jax.numpy as jnp

    cols = COLS[fmt]
    data = (REALISTIC[fmt](257, seed=1) if kind == "realistic"
            else jax_testgen.bc_blocks(257, 4 * cols, seed=2))
    got = getattr(decode, f"decode_{fmt}_bytes")(data, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (4, 257, 16)
    words = np.frombuffer(data, "<u4").reshape(-1, cols)
    want = np.asarray(getattr(jax_ddecode, f"decode_{fmt}")(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_rgba(got), getattr(jax_odecode, f"decode_{fmt}")(data))
    # the words entry point on a tensor gives the same planes
    w = torch.from_numpy(words.view(np.int32).copy())
    assert torch.equal(getattr(decode, f"decode_{fmt}")(w), got)


@pytest.mark.parametrize("fmt", ["bc1", "bc2", "bc3"])
def test_decode_edges(fmt):
    """Every word's top bit set (negative int32 words), empty input, and a length that
    is no whole number of blocks."""
    import jax.numpy as jnp

    cols = COLS[fmt]
    rng = np.random.default_rng(3)
    words = (rng.integers(0, 2**32, (64, cols), dtype=np.uint64)
             | 0x80008000).astype(np.uint32)
    data = words.tobytes()
    got = getattr(decode, f"decode_{fmt}_bytes")(data, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(getattr(jax_ddecode, f"decode_{fmt}")(jnp.asarray(words))))
    assert getattr(decode, f"decode_{fmt}_bytes")(b"", device="cpu").shape == (4, 0, 16)
    with pytest.raises(ValueError):
        getattr(decode, f"decode_{fmt}_bytes")(data[:-4], device="cpu")


def test_colour_helpers_match_the_oracle_on_every_value():
    c = np.arange(65536)
    got = decode.to_rgba8888(torch.from_numpy(c.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), jax_color565.to_rgba8888(c))
    rgb = np.random.default_rng(4).integers(0, 256, (3, 100_000))
    got = decode.from_rgb(*(torch.from_numpy(x.astype(np.int32)) for x in rgb))
    np.testing.assert_array_equal(got.numpy(), jax_color565.from_rgb(*rgb))


@pytest.mark.parametrize("start", range(8))
def test_msb_bits_match_jax(start):
    for end in range(start, 8):
        for byte in range(256):
            v = bc7.extract_msb_bits(byte, start, end)
            assert v == jax_bc7.extract_msb_bits(byte, start, end)
            for value in (0, v, (1 << (end - start + 1)) - 1):
                assert bc7.insert_msb_bits(byte, value, start, end) == \
                    jax_bc7.insert_msb_bits(byte, value, start, end)
            assert bc7.extract_msb_bits(bc7.insert_msb_bits(0, v, start, end),
                                        start, end) == v
        arr = np.arange(256, dtype=np.int64)
        np.testing.assert_array_equal(bc7.extract_msb_bits(arr, start, end),
                                      jax_bc7.extract_msb_bits(arr, start, end))
        t = torch.arange(256)
        np.testing.assert_array_equal(
            bc7.insert_msb_bits(t, bc7.extract_msb_bits(t.flip(0), start, end),
                                start, end).numpy(),
            jax_bc7.insert_msb_bits(arr, jax_bc7.extract_msb_bits(arr[::-1], start, end),
                                    start, end))


def test_msb_bits_examples():
    assert bc7.extract_msb_bits(0b10110000, 0, 0) == 1
    assert bc7.extract_msb_bits(0b10110000, 1, 3) == 0b011
    assert bc7.extract_msb_bits(0b10110001, 4, 7) == 0b0001
    assert bc7.insert_msb_bits(0, 0b101, 0, 2) == 0b10100000
    assert bc7.insert_msb_bits(0, 0b11, 6, 7) == 0b00000011
    assert bc7.BLOCK_SIZE == 16


FILES = {
    "bc1_mips_trailing": lambda: testgen.make_dds("BC1", 32, 32, 2, trailing=b"tail"),
    "bc2": lambda: testgen.make_dds("BC2", 16, 8, seed=1),
    "bc3_mips": lambda: testgen.make_dds("BC3", 64, 32, 4, seed=2),
    "bc4": lambda: testgen.make_dds("BC4", 12, 4, seed=3),
    "bc5": lambda: testgen.make_dds("BC5", 16, 16, seed=4),
    "bc7_dx10": lambda: testgen.make_dx10_dds("BC7", 16, 16, 2, seed=5),
    "bc6h_dx10": lambda: testgen.make_dx10_dds("BC6H", 16, 16, seed=6),
    "rgba8888": lambda: testgen.make_uncompressed_dds("rgba8888", 8, 8),
    "truncated": lambda: testgen.make_dds("BC1", 32, 32)[:0x80 + 40],
    "garbage": lambda: b"garbage" * 40,
}


@pytest.mark.parametrize("filt", list(debug.TransformFormatFilter), ids=lambda f: f.name)
@pytest.mark.parametrize("name", FILES)
def test_block_extraction_matches_jax(name, filt):
    data = FILES[name]()
    got = debug.extract_blocks_from_dds(data, filt)
    want = jax_debug.extract_blocks_from_dds(data,
                                             jax_debug.TransformFormatFilter[filt.name])
    if want is None:
        assert got is None
        return
    assert (got.format.name, got.data, got.block_size, got.num_blocks) == \
        (want.format.name, want.data, want.block_size, want.num_blocks)


def test_block_extraction_example():
    data = testgen.make_dds("BC1", 32, 32, mipmaps=2, trailing=b"tail")
    ex = debug.extract_blocks_from_dds(data)
    assert ex is not None and ex.format == TransformFormat.BC1
    assert ex.num_blocks == 64 + 16
    assert ex.data == data[0x80:0x80 + 80 * 8]
    assert debug.extract_blocks_from_dds(data, debug.TransformFormatFilter.BC3) is None
