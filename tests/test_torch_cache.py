"""The port's persistent caches of compressed sizes and blobs
(``dxt_lossless_transform_tpu_torch.utils.cache``), as ``tests/test_caches.py`` holds
the JAX package's, and against them: the same keys, files and directory."""

from pathlib import Path

from dxt_lossless_transform_tpu.utils import cache as jax_cache
from dxt_lossless_transform_tpu_torch.utils.cache import (
    CompressedDataCache, CompressionSizeCache,
)


def test_size_cache_persists(tmp_path: Path):
    path = tmp_path / "sizes.json"
    calls = []

    def compute():
        calls.append(1)
        return 42

    c1 = CompressionSizeCache(path)
    assert c1.get_or_compute(b"data", 3, "zstd", compute) == 42
    assert c1.get_or_compute(b"data", 3, "zstd", compute) == 42
    c1.save()
    c2 = CompressionSizeCache(path)
    assert c2.get_or_compute(b"data", 3, "zstd", compute) == 42
    assert len(calls) == 1  # second instance hit the persisted entry
    assert not list(tmp_path.glob("*.tmp"))


def test_size_cache_keys_and_unreadable_file(tmp_path: Path):
    path = tmp_path / "sizes.json"
    path.write_text("not json")
    cache = CompressionSizeCache(path)  # an unreadable file starts empty
    assert cache.get_or_compute(b"data", 3, "zstd", lambda: 1) == 1
    assert cache.get_or_compute(b"data", 4, "zstd", lambda: 2) == 2
    assert cache.get_or_compute(b"data", 3, "lz4", lambda: 3) == 3
    assert cache.get_or_compute(b"other", 3, "zstd", lambda: 4) == 4
    cache.save()
    assert len(CompressionSizeCache(path)._map) == 4


def test_blob_cache_skips_recompression(tmp_path: Path):
    cache = CompressedDataCache(tmp_path / "blobs")
    calls = []

    def compute():
        calls.append(1)
        return b"compressed-bytes"

    assert cache.get_or_compute(b"payload", 16, "zstd", compute) == b"compressed-bytes"
    assert cache.get_or_compute(b"payload", 16, "zstd", compute) == b"compressed-bytes"
    assert len(calls) == 1
    # distinct (level, algo) keys do not collide
    assert cache.get_or_compute(b"payload", 1, "zstd", lambda: b"other") == b"other"


def test_blob_cache_is_best_effort(tmp_path: Path):
    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    cache = CompressedDataCache(blocker / "blobs")  # cannot be created
    assert cache.get_or_compute(b"payload", 1, "zstd", lambda: b"blob") == b"blob"


def test_default_directory_is_shared_with_jax(tmp_path: Path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    ours = CompressionSizeCache()
    assert ours.path == jax_cache.CompressionSizeCache().path == \
        tmp_path / "dxt-lossless-transform-tpu" / "compression_size_cache.json"
    assert CompressedDataCache().dir == jax_cache.CompressedDataCache().dir
    ours.get_or_compute(b"texture", 16, "zstd", lambda: 1234)
    ours.save()
    # the JAX package reads the port's entry, and the port reads the JAX package's blob
    assert jax_cache.CompressionSizeCache().get_or_compute(
        b"texture", 16, "zstd", lambda: 0) == 1234
    jax_cache.CompressedDataCache().get_or_compute(b"texture", 16, "zstd",
                                                   lambda: b"blob")
    assert CompressedDataCache().get_or_compute(b"texture", 16, "zstd",
                                                lambda: b"") == b"blob"
