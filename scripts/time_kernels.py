#!/usr/bin/env python3
"""Time the BC1-, BC3-, BC7- and RGBA8888-path kernels and files of a checkout of
the PyTorch port on one card, in a fresh process, so that two versions of the port
can be compared in turns within one call (parent, change, change, parent).

    python3 scripts/time_kernels.py [--root DIR] [--iters N]

``--root`` is the directory that holds the ``dxt_lossless_transform_tpu_torch``
package to time (default: this checkout). On the 4096x4096 BC1 file of
``chip_smoke.py`` (1,398,103 blocks) it times ``dlt_bc1_transform`` and
``dlt_bc1_untransform`` (variant 1, split), ``dlt_bc1_regions`` and
``dlt_ltu_counts`` with the default offsets on the 8 COMPREHENSIVE colour rows:
CUDA-event medians of N launches, the 50 MB L2 flushed before each, as
``chip_smoke.py`` times them. On the 4096x4096 BC3 file it times
``dlt_bc3_transform`` and ``dlt_bc3_untransform`` (variant 1, split alpha, split
colour) and ``dlt_bc3_regions`` (COMPREHENSIVE). For both files it takes the host
wall time of the whole FAST auto-transform of the file through ``DdsHandler`` and of
its untransform (medians of 5, ``file_s``). Where the checkout has the BC7/BC6H
slice (``ops/cuda/planes.py``), it also times ``dlt_bc7_transform`` and
``dlt_bc7_untransform`` (sort and planes) on the 4096x4096 BC7 DX10 file of
``chip_smoke.py`` and that file's LTU auto-transform and untransform. Where it has
the RGB slice (``ops/cuda/channels.py``), it also times ``dlt_rgb_transform`` and
``dlt_rgb_untransform`` (split only, the file's LTU pick, and decorrelate+split, the
default) on the 4096x4096 RGBA8888 file of ``chip_smoke.py`` (16,777,216 pixels)
and that file's LTU auto-transform and untransform. Where it has the batch
pipeline's slice (``planes.deinterleave_words``), it also times
``dlt_ltu_counts_rows`` on the BC1 COMPREHENSIVE rows, every row at the file's
length, and ``dlt_deinterleave_words`` for k = 2 and 4 at N = 2,097,152 words per
stream. Prints the ``nvidia-smi`` line and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from dxt_lossless_transform_tpu_torch import backend
    from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
    from dxt_lossless_transform_tpu_torch.estimate.ltu import (
        DEFAULT_OFFSETS, offset_weight,
    )
    from dxt_lossless_transform_tpu_torch.ops.cuda import regions, shuffle
    from dxt_lossless_transform_tpu_torch.api import (
        Bc1AutoTransformBuilder, Bc3AutoTransformBuilder,
    )
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
    from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
    from dxt_lossless_transform_tpu_torch.ops import auto
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_COMPREHENSIVE_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import make_dds

    dev = torch.device("cuda", 0)
    dds = {fmt: make_dds(fmt, 4096, 4096, 13, seed=7) for fmt in ("BC1", "BC3")}
    x = backend.upload(dds["BC1"][0x80:], dev)
    x3 = backend.upload(dds["BC3"][0x80:], dev)
    alpha_keys, colour_keys, _, _ = auto.bc3_keys(BC3_COMPREHENSIVE_CANDIDATES)
    t3 = shuffle.bc3_transform(x3, 1, True, True)
    n = x.numel() // 8
    key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints)
                for c in BC1_COMPREHENSIVE_CANDIDATES)
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    t = shuffle.bc1_transform(x, 1, True)
    rows = regions.bc1_regions(x, key)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def event_ms(fn) -> float:
        fn()
        times = []
        for _ in range(args.iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    ms = {
        "dlt_bc1_transform": event_ms(lambda: shuffle.bc1_transform(x, 1, True)),
        "dlt_bc1_untransform": event_ms(lambda: shuffle.bc1_untransform(t, 1, True)),
        "dlt_bc1_regions": event_ms(lambda: regions.bc1_regions(x, key)),
        "dlt_ltu_counts": event_ms(lambda: cuda_ltu.ltu_counts(rows, 4 * n, ks, ws)),
        "dlt_bc3_transform": event_ms(lambda: shuffle.bc3_transform(x3, 1, True, True)),
        "dlt_bc3_untransform": event_ms(
            lambda: shuffle.bc3_untransform(t3, 1, True, True)),
        "dlt_bc3_regions": event_ms(
            lambda: regions.bc3_regions(x3, alpha_keys, colour_keys)),
    }
    handler = DdsHandler()
    bundles = {"BC1": TransformBundle(bc1=Bc1AutoTransformBuilder(LtuEstimation())),
               "BC3": TransformBundle(bc3=Bc3AutoTransformBuilder(LtuEstimation()))}

    def wall_s(fn) -> float:
        fn()
        times = []
        for _ in range(5):
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        return statistics.median(times)

    try:
        from dxt_lossless_transform_tpu_torch.api import Bc7AutoTransformBuilder
        from dxt_lossless_transform_tpu_torch.ops.cuda import planes
        from dxt_lossless_transform_tpu_torch.utils.testgen import make_dx10_dds
    except ImportError:  # a checkout from before the BC7/BC6H slice
        planes = None
    if planes is not None:
        dds["BC7"] = make_dx10_dds("BC7", 4096, 4096, 13, seed=7)
        bundles["BC7"] = TransformBundle(bc7=Bc7AutoTransformBuilder(LtuEstimation()))
        x7 = backend.upload(dds["BC7"][0x94:], dev)
        t7 = planes.bc7_transform(x7, planes.BC7, True, True)
        ms["dlt_bc7_transform"] = event_ms(
            lambda: planes.bc7_transform(x7, planes.BC7, True, True))
        ms["dlt_bc7_untransform"] = event_ms(
            lambda: planes.bc7_untransform(t7, n, True, True))

    try:
        from dxt_lossless_transform_tpu_torch.api import RgbAutoTransformBuilder
        from dxt_lossless_transform_tpu_torch.ops.cuda import channels
        from dxt_lossless_transform_tpu_torch.utils.testgen import make_uncompressed_dds
    except ImportError:  # a checkout from before the RGB slice
        channels = None
    if channels is not None:
        dds["RGBA8888"] = make_uncompressed_dds("rgba8888", 4096, 4096, seed=7)
        bundles["RGBA8888"] = TransformBundle(
            rgba8888=RgbAutoTransformBuilder("rgba8888", LtuEstimation()))
        xr = backend.upload(dds["RGBA8888"][0x80:], dev)
        for dec in (False, True):
            rgb_args = (*channels.LAYOUTS["rgba8888"], dec, True)
            tr = channels.rgb_transform(xr, *rgb_args)
            label = "dec_split" if dec else "split"
            ms[f"dlt_rgb_transform/{label}"] = event_ms(
                lambda: channels.rgb_transform(xr, *rgb_args))
            ms[f"dlt_rgb_untransform/{label}"] = event_ms(
                lambda: channels.rgb_untransform(tr, *rgb_args))

    if planes is not None and hasattr(planes, "deinterleave_words"):
        # the batch pipeline's slice: the per-row count kernel on the same 8 rows
        # (every row at 4n, so it reads as the scalar kernel above), and the word
        # deinterleave at the largest batch's N of chip_smoke.py's corpus
        valid = torch.full((rows.shape[0],), 4 * n)
        ms["dlt_ltu_counts_rows"] = event_ms(
            lambda: cuda_ltu.ltu_counts(rows, valid, ks, ws))
        for k in (2, 4):
            xw = torch.zeros(k * 2_097_152, dtype=torch.int32, device=dev).random_()
            ms[f"dlt_deinterleave_words/k{k}"] = event_ms(
                lambda: planes.deinterleave_words(xw, k))

    file_s = {}
    for fmt, data in dds.items():
        out = handler.transform_bundle(data, bundles[fmt])
        file_s[f"{fmt}_transform_fast"] = wall_s(
            lambda: handler.transform_bundle(data, bundles[fmt]))
        file_s[f"{fmt}_untransform"] = wall_s(lambda: handler.untransform(out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"root": args.root, "library": backend.library_path().name,
                      "iters": args.iters, "ms": ms, "file_s": file_s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
