#!/usr/bin/env python3
"""Time every kernel of the PyTorch port at the main path's shapes, on one card, for
a checkout given by its directory, in a fresh process, so that two versions of the
port can be compared in turns within one call (parent, change, change, parent).

    python3 scripts/time_kernels.py [--root DIR] [--iters N]

``--root`` is the directory that holds the ``dxt_lossless_transform_tpu_torch``
package to time (default: this checkout). Each entry of ``ms`` is a CUDA-event
median of N calls of one kernel wrapper, the 50 MB L2 flushed before each by reading
a 64 MiB buffer (``chip_smoke.kernel_ms``, the one timing method, which this script
imports from this checkout with the shapes below), at the shapes of
``chip_smoke.py``'s times phase: the 4096x4096 DDS files of ``chip_smoke.py``
(1,398,103 blocks; BC1-BC5 from ``make_dds(seed=7)``, BC7 realistic and BC6H random
blocks, RGBA8888, BGRA8888 and BGR888 at 16,777,216 pixels), each format's shuffle
kernels in the setting ``chip_smoke.py`` times, the region kernels for the FAST and
COMPREHENSIVE candidates, the count kernel (default ladder) on each search's
candidate rows, the mode-sort kernels in their three launching settings on BC7 and
BC6H, the RGB kernels in their three non-identity settings of each layout, the word
deinterleave at the largest batch's N (2,097,152 words a stream), the rows
transform kernels on 16 such files in their bucket, the per-row count
kernel on the BC1 batch's 16 rows of 2,097,152 bytes and the windowed one on them
cut into 8 shards, timed as the sum of its 8 launches' medians. ``library`` holds
the one PyTorch call that moves the same bytes (``.t().contiguous()``) beside the
mode-sort, deinterleave and RGB kernels. Where the checkout can say (its
``launch_shape`` queries), ``shapes`` holds the count, transform and untransform launches'
grids and the blocks the card holds at once.

``profiled`` holds ``torch.profiler``'s device time of each ``dlt_bc7_transform``
form and of each of the windowed cut's 8 launches (kernel, memory copies and other
device work, per call), to set beside their event medians: what of an event window
is device work. It is a record, not a second timing method.

``host_s`` holds host wall times, synchronised, medians of 5: the search alone and
the untransform through ``DdsHandler`` of the 4096x4096 BC1 (FAST), BC7 and BC6H
files, as ``chip_smoke.py`` takes them, and, medians of 3, the BC1 and BC7 batches
of ``chip_smoke.py``'s corpus (``BatchProcessor``, ``ModeSortBatchProcessor``) with
each stage of one ``timing=True`` run, and the BC1 batch on the (1, 1) and (1, 8)
meshes of the card. They are taken in this fresh process, so that two trees compare
without ``chip_smoke.py``'s check phase before them. Prints the ``nvidia-smi`` line
and one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# this script's checkout holds chip_smoke.py: its shapes, its corpus and its timing
# method; the package timed stays the one under ``--root``, first on the path
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (  # noqa: E402
    BATCH_MAX, LARGEST_BATCH_N, MIPS, SEED, SIZE, batch_corpus, bc1_batch_rows,
    kernel_ms, shard_windows,
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from dxt_lossless_transform_tpu_torch import backend
    from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
    from dxt_lossless_transform_tpu_torch.estimate.ltu import (
        DEFAULT_OFFSETS, LtuEstimation, offset_weight,
    )
    from dxt_lossless_transform_tpu_torch.ops import auto, bc7, rgb
    from dxt_lossless_transform_tpu_torch.ops.cuda import channels, planes, regions, shuffle
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
        BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
        BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, RGB_FAST_CANDIDATES,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import (
        bc_blocks, chain_blocks, make_dds, make_dx10_dds, make_uncompressed_dds,
    )

    dev = torch.device("cuda", 0)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)

    def event_ms(fn) -> float:
        return kernel_ms(fn, args.iters, flush)

    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    n = chain_blocks(SIZE, SIZE)
    xs = {fmt: backend.upload(make_dds(fmt, SIZE, SIZE, MIPS, seed=SEED)[0x80:], dev)
          for fmt in ("BC1", "BC2", "BC3", "BC4", "BC5")}
    xs["BC7"] = backend.upload(make_dx10_dds("BC7", SIZE, SIZE, MIPS, seed=SEED)[0x94:], dev)
    xs["BC6H"] = backend.upload(bc_blocks(n, 16, SEED), dev)
    ms, library, shapes = {}, {}, {}
    # label -> (call, name of the kernel it launches), for ``profiled``
    profiled = {}

    def counts(label: str, rows: torch.Tensor, valid: int) -> None:
        ms[f"dlt_ltu_counts/{label}"] = event_ms(
            lambda: cuda_ltu.ltu_counts(rows, valid, ks, ws))

    # BC1 and BC2: variant 1 split; regions and counts for both candidate sets
    for fmt, fast, comprehensive in (
            ("bc1", BC1_FAST_CANDIDATES, BC1_COMPREHENSIVE_CANDIDATES),
            ("bc2", BC2_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES)):
        x = xs[fmt.upper()]
        t = getattr(shuffle, f"{fmt}_transform")(x, 1, True)
        ms[f"dlt_{fmt}_transform"] = event_ms(
            lambda: getattr(shuffle, f"{fmt}_transform")(x, 1, True))
        ms[f"dlt_{fmt}_untransform"] = event_ms(
            lambda: getattr(shuffle, f"{fmt}_untransform")(t, 1, True))
        for label, cand in (("fast", fast), ("comprehensive", comprehensive)):
            key = auto.colour_keys(cand)[0]
            region = getattr(regions, f"{fmt}_regions")
            ms[f"dlt_{fmt}_regions/{label}"] = event_ms(lambda: region(x, key))
            counts(f"{fmt}_{label}" if fmt != "bc1" else label, region(x, key), 4 * n)
    # BC3: variant 1, split alpha, split colour
    x3 = xs["BC3"]
    t3 = shuffle.bc3_transform(x3, 1, True, True)
    ms["dlt_bc3_transform"] = event_ms(lambda: shuffle.bc3_transform(x3, 1, True, True))
    ms["dlt_bc3_untransform"] = event_ms(lambda: shuffle.bc3_untransform(t3, 1, True, True))
    for label, cand in (("fast", BC3_FAST_CANDIDATES),
                        ("comprehensive", BC3_COMPREHENSIVE_CANDIDATES)):
        akeys, ckeys = auto.bc3_keys(cand)[:2]
        ms[f"dlt_bc3_regions/{label}"] = event_ms(
            lambda: regions.bc3_regions(x3, akeys, ckeys))
        alpha, colour = regions.bc3_regions(x3, akeys, ckeys)
        counts(f"bc3_alpha_{label}", alpha, 2 * n)
        counts(f"bc3_colour_{label}", colour, 4 * n)
    # BC4 and BC5: split; the endpoint rows of both settings
    for fmt, ep in (("bc4", 2), ("bc5", 4)):
        x = xs[fmt.upper()]
        fwd, inv = getattr(shuffle, f"{fmt}_transform"), getattr(shuffle, f"{fmt}_untransform")
        t = fwd(x, True)
        ms[f"dlt_{fmt}_transform"] = event_ms(lambda: fwd(x, True))
        ms[f"dlt_{fmt}_untransform"] = event_ms(lambda: inv(t, True))
        counts(f"{fmt}_endpoints", torch.stack([fwd(x, True)[:ep * n],
                                                fwd(x, False)[:ep * n]]), ep * n)
    # BC7 and BC6H: the three launching settings of both directions, each beside the
    # PyTorch call that moves the same bytes; the search's two scoring calls
    for fmt, fmt_id, cand in (("BC7", planes.BC7, BC7_FAST_CANDIDATES),
                              ("BC6H", planes.BC6H, BC6H_FAST_CANDIDATES)):
        xm = xs[fmt]
        for sort, split in ((False, True), (True, False), (True, True)):
            label = f"{fmt.lower()}_{'sort_' if sort else ''}{'planes' if split else 'blocks'}"
            tm = planes.bc7_transform(xm, fmt_id, sort, split)
            ms[f"dlt_bc7_transform/{label}"] = event_ms(
                lambda: planes.bc7_transform(xm, fmt_id, sort, split))
            profiled[f"dlt_bc7_transform/{label}"] = (
                lambda xm=xm, fmt_id=fmt_id, sort=sort, split=split:
                planes.bc7_transform(xm, fmt_id, sort, split), "bc7_transform_kernel")
            if hasattr(planes, "transform_launch_shape"):
                shapes[f"dlt_bc7_transform/{label}"] = planes.transform_launch_shape(
                    n, fmt_id, sort, split, dev)
            ms[f"dlt_bc7_untransform/{label}"] = event_ms(
                lambda: planes.bc7_untransform(tm, n, sort, split))
            library[f"dlt_bc7_untransform/{label}"] = event_ms(
                lambda: tm[-16 * n:].view(16, n).t().contiguous())
            if hasattr(planes, "untransform_launch_shape"):
                shapes[f"dlt_bc7_untransform/{label}"] = planes.untransform_launch_shape(
                    n, sort, split, dev)
        library[f"dlt_bc7_transform/{fmt.lower()}_planes"] = event_ms(
            lambda: xm.view(n, 16).t().contiguous())
        _, streams = bc7.candidate_streams(xm, fmt_id, LtuEstimation(), cand, fmt)
        for sort in (False, True):
            rows = torch.stack([streams[sort, split] for split in (False, True)])
            counts(f"{fmt.lower()}_{'sorted' if sort else 'unsorted'}", rows, rows.shape[1])
    # RGB: every non-identity setting of each layout, both directions; the count
    # kernel on each file's four candidate rows
    pixels = SIZE * SIZE
    for layout in ("rgba8888", "bgra8888", "bgr888"):
        xr = backend.upload(make_uncompressed_dds(layout, SIZE, SIZE, seed=SEED)[0x80:], dev)
        stride = channels.LAYOUTS[layout][0]
        for dec, split in ((True, True), (True, False), (False, True)):
            rgb_args = (*channels.LAYOUTS[layout], dec, split)
            label = f"{layout}_{'dec_' if dec else ''}{'split' if split else 'interleaved'}"
            tr = channels.rgb_transform(xr, *rgb_args)
            ms[f"dlt_rgb_transform/{label}"] = event_ms(
                lambda: channels.rgb_transform(xr, *rgb_args))
            ms[f"dlt_rgb_untransform/{label}"] = event_ms(
                lambda: channels.rgb_untransform(tr, *rgb_args))
        library[f"dlt_rgb_transform/{layout}_split"] = event_ms(
            lambda: xr.view(pixels, stride).t().contiguous())
        _, rows = rgb.candidate_rows(xr, layout, LtuEstimation(), RGB_FAST_CANDIDATES)
        rows = torch.stack(list(rows.values()))
        counts(layout, rows, rows.shape[1])
        del xr, tr, rows
    # the rows kernels (the batch step's end): 16 rows, each the 4096x4096 file's n
    # blocks in its 2,097,152-block bucket, under the setting the per-file kernel is
    # timed in (and ``/mixed``: row r under FAST candidate r mod their count), the
    # block counts already on the card; beside them, 16 launches of the per-file
    # kernel on the same rows (``/per_file_x16``)
    from dxt_lossless_transform_tpu_torch.ops import lanes

    bucket, B = lanes.bucket_size(n), 16
    keys = {"bc1": (1, True), "bc2": (1, True), "bc3": (1, True, True),
            "bc4": (True,), "bc5": (True,)}
    fast = {"bc1": auto.colour_keys(BC1_FAST_CANDIDATES)[0],
            "bc2": auto.colour_keys(BC2_FAST_CANDIDATES)[0],
            "bc3": [(int(c.decorrelation_mode), c.split_alpha_endpoints,
                     c.split_colour_endpoints) for c in BC3_FAST_CANDIDATES],
            "bc4": [(False,), (True,)], "bc5": [(False,), (True,)]}
    counts_dev = torch.full((B,), n, dtype=torch.int64, device=dev)
    for fmt, key in keys.items():
        bs = shuffle._ROWS[fmt][0]
        rows = torch.zeros((B, bs * bucket), dtype=torch.uint8, device=dev)
        rows[:, :bs * n] = xs[fmt.upper()][:bs * n]
        out = torch.empty_like(rows)
        for label, cands, best in (
                ("", [key], torch.zeros(B, dtype=torch.int64, device=dev)),
                ("/mixed", fast[fmt],
                 torch.arange(B, device=dev) % len(fast[fmt]))):
            code = shuffle.rows_code(fmt, cands)
            ms[f"dlt_{fmt}_transform_rows{label}"] = event_ms(
                lambda: backend.launch(f"dlt_{fmt}_transform_rows", dev, rows.data_ptr(),
                                       out.data_ptr(), counts_dev.data_ptr(),
                                       best.data_ptr(), B, bucket, code, len(cands)))
        per_file = getattr(shuffle, f"{fmt}_transform")
        ms[f"dlt_{fmt}_transform_rows/per_file_x16"] = event_ms(
            lambda: [per_file(rows[r, :bs * n], *key) for r in range(B)])
        del rows, out
    # the word deinterleave at the largest batch's N, k = 2 and 4
    for k in (2, 4):
        xw = torch.zeros(k * LARGEST_BATCH_N, dtype=torch.int32, device=dev).random_()
        ms[f"dlt_deinterleave_words/k{k}"] = event_ms(lambda: planes.deinterleave_words(xw, k))
        library[f"dlt_deinterleave_words/k{k}"] = event_ms(
            lambda: xw.view(-1, k).t().contiguous())
    # the per-row count kernel on the BC1 batch's rows (the four 2048x2048 chains of
    # the 524,288-block bucket, each candidate key's colour row) and the windowed one
    # on them cut into 8 shards with their halos, the 8 launches of one mesh scoring;
    # lengths on the host, as every checkout's wrapper takes them
    brows, n_big = bc1_batch_rows(batch_corpus("bc1"), dev)
    bvalid = torch.full((brows.shape[0],), 4 * n_big)
    ms["dlt_ltu_counts_rows/bc1_batch"] = event_ms(
        lambda: cuda_ltu.ltu_counts(brows, bvalid, ks, ws))
    nb = 8
    windows, lc = shard_windows(brows, nb)
    ms["dlt_ltu_counts_windowed/8_shards"] = sum(
        event_ms(lambda: cuda_ltu.ltu_counts_windowed(w, bvalid, s * lc - cuda_ltu.SPAN,
                                                      ks, ws))
        for s, w in enumerate(windows))
    for s, w in enumerate(windows):
        profiled[f"dlt_ltu_counts_windowed/shard_{s}"] = (
            lambda w=w, s=s: cuda_ltu.ltu_counts_windowed(w, bvalid, s * lc - cuda_ltu.SPAN,
                                                          ks, ws), "ltu_default_kernel")
    device = device_times(torch, profiled, flush, args.iters)
    if hasattr(cuda_ltu, "launch_shape"):
        shapes["dlt_ltu_counts/comprehensive"] = cuda_ltu.launch_shape(8, 4 * n - 3,
                                                                       "scalar", dev)
        shapes["dlt_ltu_counts_rows/bc1_batch"] = cuda_ltu.launch_shape(
            brows.shape[0], 4 * n_big - 3, "rows", dev)
        shapes["dlt_ltu_counts_windowed/8_shards"] = cuda_ltu.launch_shape(
            brows.shape[0], lc, "windowed", dev)
    del windows, brows
    host_s = host_times(args.root, torch, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"root": args.root, "library_file": backend.library_path().name,
                      "iters": args.iters, "ms": ms, "library": library,
                      "windowed_launches": nb, "shapes": shapes, "host_s": host_s,
                      "profiled": device}))
    return 0


def device_times(torch, calls: dict, flush, iters: int) -> dict:
    """What ``torch.profiler`` (CPU and CUDA activities, ``key_averages()``) sees of
    each call of ``calls`` (label -> (call, kernel name)), run ``iters`` times after
    one untimed call, the L2 flushed before each as for ``ms``: per call, in ms, the
    device time of the kernels whose name holds the kernel name, of memory copies and
    sets, and of other device work besides the flush's reduction, with the kernel's
    launches per call. A call whose device times are all 0 means the profiler saw
    no device activity."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, (fn, kernel) in calls.items():
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        got = {"kernel_ms": 0.0, "copy_ms": 0.0, "other_ms": 0.0, "kernel_launches": 0.0}
        for avg in prof.key_averages():
            if avg.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(avg, "self_device_time_total", None)
            if us is None:
                us = avg.self_cuda_time_total
            if kernel in avg.key:
                got["kernel_ms"] += us / 1e3 / iters
                got["kernel_launches"] += avg.count / iters
            elif "Memcpy" in avg.key or "Memset" in avg.key:
                got["copy_ms"] += us / 1e3 / iters
            elif "reduce" not in avg.key.lower():
                got["other_ms"] += us / 1e3 / iters
        out[label] = got
    return out


def host_times(root: str, torch, dev) -> dict:
    """The host wall times of ``host_s`` (see the module's docstring)."""
    from dxt_lossless_transform_tpu_torch import backend, parallel
    from dxt_lossless_transform_tpu_torch.api import (
        Bc1AutoTransformBuilder, Bc6hAutoTransformBuilder, Bc7AutoTransformBuilder,
    )
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
    from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
    from dxt_lossless_transform_tpu_torch.ops import auto, bc7
    from dxt_lossless_transform_tpu_torch.ops.cuda import planes
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_FAST_CANDIDATES, BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import (
        bc_blocks, chain_blocks, make_dds, make_dx10_dds,
    )

    def wall_s(fn, reps: int) -> float:
        fn()
        times = []
        for _ in range(reps):
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        return statistics.median(times)

    out = {}
    handler = DdsHandler()
    files = {
        "BC1": (make_dds("BC1", SIZE, SIZE, MIPS, seed=SEED),
                TransformBundle(bc1=Bc1AutoTransformBuilder(LtuEstimation())), 0x80,
                lambda x: auto.candidate_scores(x, LtuEstimation(), BC1_FAST_CANDIDATES)),
        "BC7": (make_dx10_dds("BC7", SIZE, SIZE, MIPS, seed=SEED),
                TransformBundle(bc7=Bc7AutoTransformBuilder(LtuEstimation())), 0x94,
                lambda x: bc7.candidate_streams(x, planes.BC7, LtuEstimation(),
                                                BC7_FAST_CANDIDATES, "BC7")),
        "BC6H": (make_dx10_dds("BC6H", SIZE, SIZE, MIPS,
                               payload=bc_blocks(chain_blocks(SIZE, SIZE), 16, SEED)),
                 TransformBundle(bc6h=Bc6hAutoTransformBuilder(LtuEstimation())), 0x94,
                 lambda x: bc7.candidate_streams(x, planes.BC6H, LtuEstimation(),
                                                 BC6H_FAST_CANDIDATES, "BC6H"))}
    for fmt, (data, bundle, header, search) in files.items():
        x = backend.upload(data[header:], dev)
        transformed = handler.transform_bundle(data, bundle)
        out[f"{fmt}_search"] = wall_s(lambda: search(x), 5)
        out[f"{fmt}_untransform_file"] = wall_s(lambda: handler.untransform(transformed), 5)
    for fmt, make in (("bc1", parallel.BatchProcessor), ("bc7", parallel.ModeSortBatchProcessor)):
        data = batch_corpus(fmt)
        out[f"{fmt}_batch"] = wall_s(lambda: make(fmt, max_batch=BATCH_MAX).process(data), 3)
        staged = make(fmt, max_batch=BATCH_MAX, timing=True)
        staged.process(data)
        out[f"{fmt}_batch_stages"] = staged.times.seconds
    data = batch_corpus("bc1")
    for name, devices in (("1x1", [dev]), ("1x8", [dev] * 8)):
        mesh = parallel.make_mesh(devices=devices)
        out[f"bc1_batch_mesh_{name}"] = wall_s(lambda: parallel.BatchProcessor(
            "bc1", mesh=mesh, max_batch=BATCH_MAX).process(data), 3)
    return out


if __name__ == "__main__":
    sys.exit(main())
