"""The port's ``ZstdEstimation`` (the system libzstd through ctypes) against the
JAX package's native runtime, which compresses with the same library and the same
magicless parameters: sizes must be equal."""

import numpy as np
import pytest

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
