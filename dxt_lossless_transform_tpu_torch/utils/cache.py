"""Persistent caches of compressed sizes and compressed blobs for the debug commands
(counterpart of ``dxt_lossless_transform_tpu/utils/cache.py``, with the same keys,
the same files and the same cache directory, so the two packages share entries).

A (content hash, level, algorithm) key, the content hashed with blake2b-128, maps to
a compressed size in one JSON file (:class:`CompressionSizeCache`) or to the
compressed bytes in one file per blob (:class:`CompressedDataCache`), under
``$XDG_CACHE_HOME/dxt-lossless-transform-tpu`` (``~/.cache`` by default), so that
repeated stats and benchmark runs skip recompression.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Callable, Optional


def _default_cache_dir() -> Path:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return Path(base) / "dxt-lossless-transform-tpu"


def _hash(content: bytes) -> str:
    return hashlib.blake2b(content, digest_size=16).hexdigest()


class CompressionSizeCache:
    """(content hash, level, algorithm) -> compressed size, persisted as JSON."""

    def __init__(self, path: Optional[Path] = None):
        self.path = Path(path) if path else _default_cache_dir() / "compression_size_cache.json"
        self._dirty = False
        try:
            self._map: dict = json.loads(self.path.read_text())
        except (OSError, ValueError):
            self._map = {}

    @staticmethod
    def _key(content: bytes, level: int, algo: str) -> str:
        return f"{_hash(content)}:{level}:{algo}"

    def get_or_compute(self, content: bytes, level: int, algo: str,
                       compute: Callable[[], int]) -> int:
        key = self._key(content, level, algo)
        if key not in self._map:
            self._map[key] = int(compute())
            self._dirty = True
        return self._map[key]

    def save(self) -> None:
        """Write the map if it changed, through a temporary file renamed into place."""
        if not self._dirty:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._map))
        tmp.replace(self.path)
        self._dirty = False


class CompressedDataCache:
    """(content hash, level, algorithm) -> compressed bytes, one file per blob; the
    cache is best-effort: a blob that cannot be written is still returned."""

    def __init__(self, path: Optional[Path] = None):
        self.dir = Path(path) if path else _default_cache_dir() / "compressed_blobs"

    @staticmethod
    def _name(content: bytes, level: int, algo: str) -> str:
        return f"{_hash(content)}-{level}-{algo}.bin"

    def get_or_compute(self, content: bytes, level: int, algo: str,
                       compute: Callable[[], bytes]) -> bytes:
        blob_path = self.dir / self._name(content, level, algo)
        try:
            return blob_path.read_bytes()
        except OSError:
            pass
        blob = compute()
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = blob_path.with_suffix(".tmp")
            tmp.write_bytes(blob)
            tmp.replace(blob_path)
        except OSError:
            pass
        return blob
