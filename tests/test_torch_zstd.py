"""The port's ``ZstdEstimation`` (the system libzstd through ctypes) against the
JAX package's native runtime, which compresses with the same library and the same
magicless parameters: sizes must be equal."""

import numpy as np
import pytest
import zstandard

from dxt_lossless_transform_tpu import runtime
from dxt_lossless_transform_tpu.estimate.zstd import ZstdEstimation as JaxZstd
from dxt_lossless_transform_tpu.utils import testgen as jax_testgen
from dxt_lossless_transform_tpu_torch import convert
from dxt_lossless_transform_tpu_torch.errors import ZstdUnavailableError
from dxt_lossless_transform_tpu_torch.estimate import zstd
from dxt_lossless_transform_tpu_torch.estimate.zstd import ZstdEstimation

BUFFERS = {
    "bc7": jax_testgen.bc7_realistic(3000, 1),
    "random": jax_testgen.bc_blocks(2000, 16, 2),
    "zeros": bytes(70000),
    "one byte": b"\x07",
    "bc1": jax_testgen.bc1_realistic(5000, 3),
}


@pytest.mark.parametrize("name", BUFFERS)
@pytest.mark.parametrize("level", [1, 3, 19])
def test_sizes_equal_the_native_runtime(level, name):
    data = BUFFERS[name]
    est = ZstdEstimation(level)
    assert est.estimate(data) == runtime.zstd_estimate(data, level) == \
        JaxZstd(level).estimate(data)


@pytest.mark.parametrize("level", [1, 3, 19])
def test_batch_equals_single_estimates(level):
    bufs = list(BUFFERS.values()) + [b""]
    est = ZstdEstimation(level)
    assert est.estimate_batch(bufs) == [est.estimate(b) for b in bufs] == \
        runtime.zstd_estimate_batch(bufs[:-1], level) + [0]
    assert est.estimate_batch(bufs[:1]) == [est.estimate(bufs[0])]


def test_buffer_types():
    data = BUFFERS["bc7"]
    est = ZstdEstimation(1)
    want = est.estimate(data)
    assert est.estimate(bytearray(data)) == est.estimate(memoryview(data)) == \
        est.estimate(np.frombuffer(data, np.uint8)) == \
        est.estimate(np.frombuffer(data, "<u4")) == want
    assert est.estimate(b"") == 0
    assert est.max_compressed_size(1000) == JaxZstd(1).max_compressed_size(1000)


@pytest.mark.parametrize("level", [0, 23, -1])
def test_levels_outside_1_to_22_raise(level):
    with pytest.raises(ValueError):
        ZstdEstimation(level)
    with pytest.raises(ValueError):
        JaxZstd(level)


def test_missing_library_is_a_typed_error(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-missing.so.99")
    with pytest.raises(ZstdUnavailableError, match="libzstd-missing.so.99") as info:
        ZstdEstimation(1)
    assert info.value.library == "libzstd-missing.so.99"
    assert isinstance(info.value, RuntimeError)


def test_library_is_found_and_reported():
    assert zstd.version() >= 10400
    assert "libzstd" in zstd.library_path()


def test_convert_from_reference():
    est = convert.from_reference(JaxZstd(7))
    assert isinstance(est, ZstdEstimation) and est.level == 7


# compress and decompress


def _zstandard_magicless(level: int):
    return zstandard.ZstdCompressor(compression_params=zstandard.ZstdCompressionParameters
                                    .from_level(level, format=zstandard.FORMAT_ZSTD1_MAGICLESS,
                                                write_content_size=False,
                                                write_checksum=False, write_dict_id=False))


@pytest.mark.parametrize("name", BUFFERS)
@pytest.mark.parametrize("level", [1, 3, 19])
def test_compress_equals_the_native_runtime(level, name):
    """The same system library and parameters as the JAX package's native runtime:
    the same frame, byte for byte; its size is the estimate."""
    data = BUFFERS[name]
    est = ZstdEstimation(level)
    blob = est.compress(data)
    assert blob == runtime.zstd_compress(data, level)
    assert len(blob) == est.estimate(data)
    assert est.decompress(blob, len(data)) == data


@pytest.mark.parametrize("name", BUFFERS)
@pytest.mark.parametrize("level", [1, 3, 19])
def test_round_trips_with_zstandard(level, name):
    """``zstandard`` (another zstd version) reads the port's frames, and the port
    reads its frames."""
    data = BUFFERS[name]
    blob = ZstdEstimation(level).compress(data)
    dctx = zstandard.ZstdDecompressor(format=zstandard.FORMAT_ZSTD1_MAGICLESS)
    assert dctx.decompress(blob, max_output_size=len(data)) == data
    theirs = _zstandard_magicless(level).compress(data)
    assert ZstdEstimation(1).decompress(theirs, len(data)) == data
    assert JaxZstd(level).decompress(blob, len(data)) == data


def test_compress_buffer_types_and_empty():
    data = BUFFERS["bc1"]
    est = ZstdEstimation(3)
    want = est.compress(data)
    assert est.compress(bytearray(data)) == est.compress(memoryview(data)) == \
        est.compress(np.frombuffer(data, "<u4")) == want
    empty = est.compress(b"")
    assert empty == runtime.zstd_compress(b"", 3) and est.decompress(empty, 0) == b""


def test_decompress_shorter_content_is_returned():
    """``expected_len`` caps the output; a frame with less in it gives what it has,
    as ``zstandard``'s ``max_output_size`` does."""
    data = BUFFERS["bc7"]
    blob = ZstdEstimation(1).compress(data)
    assert ZstdEstimation(1).decompress(blob, len(data) + 1000) == data


@pytest.mark.parametrize("short", [1, 100])
def test_decompress_past_expected_len_raises(short):
    data = BUFFERS["bc7"]
    est = ZstdEstimation(1)
    blob = est.compress(data)
    with pytest.raises(RuntimeError, match="zstd decompression failed"):
        est.decompress(blob, len(data) - short)
    with pytest.raises(zstandard.ZstdError):  # the JAX package raises too
        JaxZstd(1).decompress(blob, len(data) - short)


@pytest.mark.parametrize("corrupt", ["garbage", "zeros", "truncated"])
def test_decompress_of_a_corrupt_frame_raises(corrupt):
    whole = ZstdEstimation(1).compress(BUFFERS["bc1"])
    blob = {"garbage": b"garbage!", "zeros": bytes(3),
            "truncated": whole[:len(whole) // 2]}[corrupt]
    with pytest.raises(RuntimeError, match="zstd decompression failed"):
        ZstdEstimation(1).decompress(blob, len(BUFFERS["bc1"]))
