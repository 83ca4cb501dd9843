"""Byte-size and throughput pretty-printing for the CLI (counterpart of
``dxt_lossless_transform_tpu/utils/throughput.py``)."""

from __future__ import annotations


def format_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.2f} TiB"


def format_throughput(nbytes: int, seconds: float) -> str:
    if seconds <= 0:
        return "inf"
    return f"{format_bytes(nbytes / seconds)}/s"
