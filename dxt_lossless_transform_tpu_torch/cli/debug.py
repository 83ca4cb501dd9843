"""Debug subcommands: roundtrip validation, compression stats, benchmarks and the
corpus report (counterpart of ``dxt_lossless_transform_tpu/cli/debug.py``, the
reference CLI's ``debug-bcN`` suite, ``commands/debug_bc1/*.rs``).

Every transform and untransform runs on the command's ``--device``; compression is
zstd through the system library (:class:`~..estimate.ZstdEstimation`). The
``debug-endian*`` subcommands are not here: they wait for the endian layer.
"""

from __future__ import annotations

import struct
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

from ..estimate import LtuEstimation, ZstdEstimation
from ..formats.dds import BLOCK_SIZES, DdsFormat, parse_dds
from ..oracle import decode as odecode
from ..ops import auto as ops_auto, bc1 as ops_bc1, bc2 as ops_bc2, \
    bc3 as ops_bc3, bc7 as ops_bc7
from ..settings import (
    Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
    Bc7TransformSettings,
)
from ..utils.cache import CompressedDataCache, CompressionSizeCache
from ..utils.throughput import format_bytes, format_throughput

_FMT = {
    "bc1": (DdsFormat.BC1, Bc1TransformSettings, ops_bc1, odecode.decode_bc1,
            ops_auto.transform_bc1_auto),
    "bc2": (DdsFormat.BC2, Bc2TransformSettings, ops_bc2, odecode.decode_bc2,
            ops_auto.transform_bc2_auto),
    "bc3": (DdsFormat.BC3, Bc3TransformSettings, ops_bc3, odecode.decode_bc3,
            ops_auto.transform_bc3_auto),
    # BC7: byte-exact roundtrip only (no pixel decoder; byte equality is strictly
    # stronger than a decode-compare)
    "bc7": (DdsFormat.BC7, Bc7TransformSettings, ops_bc7, None,
            ops_bc7.transform_bc7_auto),
}


def _payloads(root: Path, want: DdsFormat):
    from .main import find_all_files
    for f in find_all_files(root):
        try:
            data = f.read_bytes()
        except OSError:
            continue
        info = parse_dds(data)
        if info is None or info.format != want:
            continue
        payload = data[info.data_offset:info.data_offset + info.data_length]
        bs = BLOCK_SIZES[want]
        yield f, payload[: len(payload) // bs * bs]


def cmd_roundtrip(args):
    """For EVERY settings combination: transform -> untransform -> decode every block
    and compare all 16 pixels against the original (``roundtrip.rs:53-126``)."""
    fmt, settings_cls, ops, decode, _ = _FMT[args.format]
    dev = args.device
    checked = 0
    for f, payload in _payloads(Path(args.input), fmt):
        base = decode(payload) if decode else None
        for s in settings_cls.all_combinations():
            rt = ops.untransform(ops.transform(payload, s, device=dev), s, device=dev)
            if rt != payload:
                print(f"FAIL (bytes) {f} {s}")
                return 1
            if decode and not np.array_equal(decode(rt), base):
                print(f"FAIL (pixels) {f} {s}")
                return 1
        checked += 1
        print(f"ok {f}")
    print(f"roundtrip ok: {checked} files x {len(list(settings_cls.all_combinations()))} "
          f"settings combos")
    return 0 if checked else 1


def cmd_compression_stats(args):
    """All-settings brute force vs API-recommended vs default compressed sizes
    (``calc_compression_stats.rs:29-100``)."""
    fmt, settings_cls, ops, _, auto_fn = _FMT[args.format]
    dev = args.device
    est = ZstdEstimation(args.level)
    cache = CompressionSizeCache()
    totals = {"original": 0, "default": 0, "api": 0, "best": 0}
    files = 0
    for f, payload in _payloads(Path(args.input), fmt):
        if not payload:
            continue
        files += 1

        def csize(blob: bytes) -> int:
            return cache.get_or_compute(blob, args.level, "zstd",
                                        lambda: len(est.compress(blob)))

        totals["original"] += csize(payload)
        totals["default"] += csize(ops.transform(payload, settings_cls(), device=dev))
        api_out, _ = auto_fn(payload, est, use_all_decorrelation_modes=True, device=dev)
        totals["api"] += csize(api_out)
        totals["best"] += min(csize(ops.transform(payload, s, device=dev))
                              for s in settings_cls.all_combinations())
    cache.save()
    if not files:
        print("no matching files", file=sys.stderr)
        return 1
    orig = totals["original"]
    print(f"files: {files}  (zstd level {args.level})")
    for k in ("original", "default", "api", "best"):
        ratio = 100.0 * totals[k] / orig if orig else 0.0
        print(f"  {k:9s} {format_bytes(totals[k]):>12s}  ({ratio:6.2f}% of original)")
    return 0


def cmd_benchmark(args):
    """Decompress+untransform timing vs plain decompress (``benchmark.rs:31-120``).

    Compressed blobs persist in the CompressedDataCache (the analog of the
    reference's ``compressed_data_cache.rs``), so reruns skip recompression."""
    fmt, settings_cls, ops, _, _ = _FMT[args.format]
    dev = args.device
    est = ZstdEstimation(args.level)
    settings = settings_cls()
    blob_cache = CompressedDataCache()
    rows = []
    for f, payload in _payloads(Path(args.input), fmt):
        if not payload:
            continue
        transformed = ops.transform(payload, settings, device=dev)
        blob_plain = blob_cache.get_or_compute(payload, args.level, "zstd",
                                               lambda: est.compress(payload))
        blob_t = blob_cache.get_or_compute(transformed, args.level, "zstd",
                                           lambda: est.compress(transformed))
        # warmup (transformed may differ in size from the original: BC7 mode stream)
        for _ in range(args.warmup):
            est.decompress(blob_plain, len(payload))
            ops.untransform(est.decompress(blob_t, len(transformed)), settings,
                            device=dev)
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            est.decompress(blob_plain, len(payload))
        t_plain = (time.perf_counter() - t0) / args.iterations
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            ops.untransform(est.decompress(blob_t, len(transformed)), settings,
                            device=dev)
        t_both = (time.perf_counter() - t0) / args.iterations
        rows.append((f, len(payload), t_plain, t_both, len(blob_plain), len(blob_t)))
    for f, n, t_plain, t_both, sp, st in rows:
        print(f"{f}: {format_bytes(n)} plain {format_throughput(n, t_plain)} "
              f"({sp} B) | decompress+untransform {format_throughput(n, t_both)} ({st} B)")
    return 0 if rows else 1


def cmd_benchmark_determine_best(args):
    """Estimator throughput + selection quality vs the zstd ground truth
    (``benchmark_determine_best.rs`` analog)."""
    fmt, settings_cls, ops, _, auto_fn = _FMT[args.format]
    dev = args.device
    zstd_truth = ZstdEstimation(args.level)
    estimators = [("ltu", LtuEstimation()), ("zstd-1", ZstdEstimation(1))]
    stats = {name: {"bytes": 0, "time": 0.0, "true_size": 0} for name, _ in estimators}
    best_possible = 0
    files = 0
    for f, payload in _payloads(Path(args.input), fmt):
        if not payload:
            continue
        files += 1
        truth = {s: zstd_truth.estimate(ops.transform(payload, s, device=dev))
                 for s in settings_cls.all_combinations()}
        best_possible += min(truth.values())
        for name, est in estimators:
            t0 = time.perf_counter()
            _, chosen = auto_fn(payload, est, use_all_decorrelation_modes=True,
                                device=dev)
            stats[name]["time"] += time.perf_counter() - t0
            stats[name]["bytes"] += len(payload)
            stats[name]["true_size"] += truth[chosen]
    if not files:
        print("no matching files", file=sys.stderr)
        return 1
    print(f"files: {files}; ground truth: zstd level {args.level}")
    for name, _ in estimators:
        s = stats[name]
        acc = 100.0 * best_possible / s["true_size"] if s["true_size"] else 0.0
        print(f"  {name:8s} {format_throughput(s['bytes'], s['time']):>14s}  "
              f"selection efficiency {acc:6.2f}% (100% = always picks the true best)")
    return 0


def cmd_format_analysis(args):
    """Corpus composition report (``debug-format-analysis`` analog): format,
    dimension, and mip-count distribution of every parseable DDS under a tree."""
    from .main import find_all_files

    formats = Counter()
    sizes = Counter()
    total_payload = 0
    files = 0
    for f in find_all_files(Path(args.input)):
        try:
            data = f.read_bytes()
        except OSError:
            continue
        info = parse_dds(data)
        if info is None:
            continue
        files += 1
        formats[info.format.name] += 1
        total_payload += info.data_length
        w = struct.unpack_from("<I", data, 0x10)[0]
        h = struct.unpack_from("<I", data, 0x0C)[0]
        sizes[f"{w}x{h}"] += 1
    if not files:
        print("no DDS files found", file=sys.stderr)
        return 1
    print(f"{files} DDS files, {format_bytes(total_payload)} texture payload")
    for name, count in formats.most_common():
        print(f"  {name:10s} {count}")
    for dim, count in sizes.most_common(10):
        print(f"  {dim:12s} {count}")
    return 0


def register(sub):
    p_fa = sub.add_parser("debug-format-analysis", help="corpus composition report")
    p_fa.add_argument("input")
    p_fa.set_defaults(fn=cmd_format_analysis)

    for fmt in ("bc1", "bc2", "bc3", "bc7"):
        p = sub.add_parser(f"debug-{fmt}", help=f"debug commands for {fmt.upper()}")
        dsub = p.add_subparsers(dest="debug_command", required=True)

        p_r = dsub.add_parser("roundtrip", help="validate all settings combos bit+pixel exact")
        p_r.add_argument("input")
        p_r.set_defaults(fn=cmd_roundtrip, format=fmt)

        p_s = dsub.add_parser("calc-compression-stats")
        p_s.add_argument("input")
        p_s.add_argument("--level", type=int, default=16)
        p_s.set_defaults(fn=cmd_compression_stats, format=fmt)

        p_b = dsub.add_parser("benchmark")
        p_b.add_argument("input")
        p_b.add_argument("--level", type=int, default=16)
        p_b.add_argument("--warmup", type=int, default=1)
        p_b.add_argument("--iterations", type=int, default=5)
        p_b.set_defaults(fn=cmd_benchmark, format=fmt)

        p_d = dsub.add_parser("benchmark-determine-best",
                              help="estimator speed + selection quality")
        p_d.add_argument("input")
        p_d.add_argument("--level", type=int, default=16)
        p_d.set_defaults(fn=cmd_benchmark_determine_best, format=fmt)
