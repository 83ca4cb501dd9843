#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dxt_lossless_transform_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as a JSON line with its wall time:

1. device: the card as ``nvidia-smi`` names it, its power limit, the PyTorch build;
2. build: the one ``nvcc`` call that builds the seven kernels from the two sources
   ``csrc/bc1_kernels.cu`` and ``csrc/bc3_kernels.cu`` into one library under
   ``build/cuda/`` (skipped when that library is already built);
3. check: each kernel against its plain PyTorch version, both on the card, byte for
   byte and for scores as exact integers: every setting (8 for BC1, 16 for BC3),
   n in {1, 3, 2048, 1,398,103} blocks, the FAST and COMPREHENSIVE candidate sets;
   the count kernel also on offsets beyond its 4096-byte halo and on a 40-offset
   ladder; inputs shorter than one block through both auto-searches;
4. main: the production path through the entry points a user calls: a 4096x4096
   BC1 DDS file and a 4096x4096 BC3 DDS file, each with its full 13-level mip
   chain (1,398,103 blocks; payloads of 11,184,824 and 22,369,648 bytes),
   auto-transformed under the LTU estimator with the FAST and the COMPREHENSIVE
   candidates, then untransformed. The files must come back byte-identical, and
   the picks, the exact integer scores and the transformed files' sha256 must equal
   the JAX package's (constants below). Every kernel must have been launched in
   this phase;
5. times: CUDA-event medians of each kernel at the main path's shapes beside its
   plain version and its bound, and the wall time of one transform and one
   untransform of each file, with the host<->device copies shown apart.

The last three lines are the ``nvidia-smi`` line, a JSON line with every kernel's
numbers and ``{"ok": true, "device": {...}}``. Any mismatch, build failure or
launch error ends the run with a non-zero exit code; so does a machine without a
CUDA device, and a directory without the package.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

TIME_LIMIT_S = 1100

# Reference constants, from the JAX package's exact integer scorer on the same files
# (for BC3 a candidate's score is its alpha region's plus its colour region's):
#     JAX_PLATFORMS=cpu python scripts/torch_port_reference.py
SIZE, MIPS, SEED = 4096, 13, 7
BLOCKS = 1398103
FILE_SHA256 = {"BC1": "e07169bacbb49da01c672e1141cf4975372d92b352185762f0b108300f56f94f",
               "BC3": "4063e4a3827e3234aa1cf9f86908037d1206107059e07821d9b50a3b3d47feab"}
REFERENCE = {
    "BC1": {
        "fast": {"scores": [132521388, 131980904, 132369283, 131964940],
                 "pick": (1, True),
                 "sha256": "8701ab8096774d6384ceb58a155050266fd59e6898ec343ba10cc774472ad5d6"},
        "comprehensive": {"scores": [132434502, 132521388, 131980904, 132370408,
                                     131967433, 131996919, 132369283, 131964940],
                          "pick": (1, True),
                          "sha256": "8701ab8096774d6384ceb58a155050266fd59e6898ec343ba10cc774472ad5d6"},
    },
    "BC3": {
        "fast": {"scores": [199634367, 199230024, 199786472, 199258050, 199245988,
                            199242086, 199798534, 199646429],
                 "pick": (1, True, True),
                 "sha256": "63f2777c858b3dbda930f3a511136d4bf11e74d95e5e39200fda226f47ee9096"},
        "comprehensive": {"scores": [199699586, 199262003, 199232517, 199635492,
                                     199634367, 199244579, 199230024, 199274065,
                                     199711648, 199647554, 199786472, 199258050,
                                     199245988, 199242086, 199798534, 199646429],
                          "pick": (1, True, True),
                          "sha256": "63f2777c858b3dbda930f3a511136d4bf11e74d95e5e39200fda226f47ee9096"},
    },
}

CSRC = "dxt_lossless_transform_tpu_torch/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "dlt_bc1_transform": ("bc1_kernels.cu",
                          "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:157"),
    "dlt_bc1_untransform": ("bc1_kernels.cu",
                            "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:185"),
    "dlt_bc1_regions": ("bc1_kernels.cu",
                        "dxt_lossless_transform_tpu/ops/pallas/regions.py:60"),
    "dlt_ltu_counts": ("bc1_kernels.cu",
                       "dxt_lossless_transform_tpu/estimate/pallas_ltu.py:302"),
    "dlt_bc3_transform": ("bc3_kernels.cu",
                          "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:301"),
    "dlt_bc3_untransform": ("bc3_kernels.cu",
                            "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:354"),
    "dlt_bc3_regions": ("bc3_kernels.cu",
                        "dxt_lossless_transform_tpu/ops/pallas/regions.py:114"),
}
# The count kernel's far instantiation: offsets beyond its 4096-byte halo, and a
# 40-offset ladder (more than the near table's 32).
FAR_OFFSETS = (1, 2, 4096, 4097, 8192, 65536)
LADDER_40 = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 20, 24, 28, 32,
             40, 48, 64, 80, 96, 128, 160, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
             4096, 6144, 12288, 24576, 49152)
# Peak rates for the bounds. Device memory bytes/s by card, from NVIDIA's data
# sheets. Integer operations/s: a Hopper SM issues 32-bit integer work to 64 INT32
# lanes (16 in each of its 4 partitions, NVIDIA's H100 architecture whitepaper),
# so the rate is SMs x 64 x the card's maximum SM clock, read from the card.
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100": 3.35e12, "H200": 4.8e12}
INT32_LANES_PER_SM = 64
# Integer operations per item that the functions need, estimated from the
# arithmetic in csrc/bc1_kernels.cu: 27 per YCoCg pair (shifts, masks, adds,
# subtractions, packing); 4 to build a position's gram and 5 for each gram it
# compares. The bounds use these.
OPS_PAIR = 27
OPS_GRAM, OPS_COMPARE = 4, 5
# Integer instructions the compiled count kernel issues (python3
# scripts/sass_ops.py, sm_90a): 13 in its compare loop and 19 more per position.
# They give the count kernel's issue time, which the times phase prints beside its
# bound.
SASS_PER_COMPARE, SASS_PER_POSITION = 13, 19


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0, **fields}),
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def memory_rate(name: str) -> tuple:
    """(bytes/s, the data-sheet entry used) for the card ``name``; a card not in the
    table is reckoned as an H100 SXM, and the device line says so."""
    for key in ("H100 PCIe", "H200", "H100"):
        if key in name:
            return MEMORY_RATE[key], key
    return MEMORY_RATE["H100"], "H100 (assumed)"


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dxt_lossless_transform_tpu_torch import backend
    from dxt_lossless_transform_tpu_torch.api import (
        Bc1AutoTransformBuilder, Bc3AutoTransformBuilder,
    )
    from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu
    from dxt_lossless_transform_tpu_torch.estimate.ltu import (
        DEFAULT_OFFSETS, LtuEstimation, coverage_scores, offset_weight,
    )
    from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
    from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
    from dxt_lossless_transform_tpu_torch.ops import auto
    from dxt_lossless_transform_tpu_torch.ops.cuda import regions, shuffle
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES,
        BC3_FAST_CANDIDATES, Bc1TransformSettings, Bc3TransformSettings,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import make_dds

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # ---- 1. device ------------------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    rate, rate_of = memory_rate(kind)
    clock = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, timeout=60, check=True).stdout.strip()
    # the H100 SXM data sheet's boost clock where the card does not report one
    sm_clock_mhz = float(clock) if clock.replace(".", "").isdigit() else 1980.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    emit("device", t0, nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, memory_rate=rate,
         memory_rate_of=rate_of, sms=sms, max_sm_clock_mhz=sm_clock_mhz,
         max_sm_clock_read=clock,
         int32_ops_rate=int_rate)

    # ---- 2. build -------------------------------------------------------------------
    t0 = time.perf_counter()
    path, compiler_output = backend.build()
    backend.library()
    emit("build", t0, library=os.path.relpath(path), built=bool(compiler_output),
         ptxas=[line for line in compiler_output.splitlines()
                if "Used" in line or "spill" in line or "Compiling" in line])

    # ---- 3. kernels against their plain versions, on the card -------------------------
    t0 = time.perf_counter()
    ks = sorted(DEFAULT_OFFSETS)
    ws = [offset_weight(k) for k in ks]
    dds = {fmt: make_dds(fmt, SIZE, SIZE, MIPS, seed=SEED) for fmt in ("BC1", "BC3")}
    for fmt, data in dds.items():
        if hashlib.sha256(data).hexdigest() != FILE_SHA256[fmt]:
            fail(f"make_dds gave another {fmt} file than the reference run")
    payload = {fmt: data[0x80:] for fmt, data in dds.items()}
    max_err = {name: 0 for name in KERNELS}

    def compare(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        sync()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {what}: {got.dtype}{tuple(got.shape)} vs "
                 f"{want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        if err:
            fail(f"{name} {what}: differs from the plain version by up to {err}")

    def compare_counts(rows: torch.Tensor, valid: int, offsets, what: str) -> None:
        weights = [offset_weight(k) for k in offsets]
        compare("dlt_ltu_counts", cuda_ltu.ltu_counts(rows, valid, offsets, weights),
                cuda_ltu.ltu_counts_plain(rows, valid, offsets, weights), what)

    bc1_keys = {label: tuple((int(c.decorrelation_mode), c.split_colour_endpoints)
                             for c in cand)
                for label, cand in (("fast", BC1_FAST_CANDIDATES),
                                    ("comprehensive", BC1_COMPREHENSIVE_CANDIDATES))}
    bc3_keys = {label: auto.bc3_keys(cand)[:2]
                for label, cand in (("fast", BC3_FAST_CANDIDATES),
                                    ("comprehensive", BC3_COMPREHENSIVE_CANDIDATES))}
    rng = np.random.default_rng(SEED)
    checked = []
    for n in (1, 3, 2048, BLOCKS):
        host = (payload["BC1"] if n == BLOCKS
                else rng.integers(0, 256, 8 * n, np.uint8).tobytes())
        x = backend.upload(host, dev)
        for s in Bc1TransformSettings.all_combinations():
            v, sp = int(s.decorrelation_mode), s.split_colour_endpoints
            t = shuffle.bc1_transform(x, v, sp)
            compare("dlt_bc1_transform", t, shuffle.bc1_transform_plain(x, v, sp),
                    f"n={n} {s}")
            u = shuffle.bc1_untransform(t, v, sp)
            compare("dlt_bc1_untransform", u, shuffle.bc1_untransform_plain(t, v, sp),
                    f"n={n} {s}")
            compare("dlt_bc1_untransform", u, x, f"n={n} {s} round trip")
        for label, key in bc1_keys.items():
            rows = regions.bc1_regions(x, key)
            compare("dlt_bc1_regions", rows, regions.bc1_regions_plain(x, key),
                    f"n={n} {label}")
            for valid in sorted({4 * n, max(4 * n - 5, 0)}):
                compare_counts(rows, valid, ks, f"BC1 n={n} {label} valid_len={valid}")
        host = (payload["BC3"] if n == BLOCKS
                else rng.integers(0, 256, 16 * n, np.uint8).tobytes())
        x = backend.upload(host, dev)
        for s in Bc3TransformSettings.all_combinations():
            args = (int(s.decorrelation_mode), s.split_alpha_endpoints,
                    s.split_colour_endpoints)
            t = shuffle.bc3_transform(x, *args)
            compare("dlt_bc3_transform", t, shuffle.bc3_transform_plain(x, *args),
                    f"n={n} {s}")
            u = shuffle.bc3_untransform(t, *args)
            compare("dlt_bc3_untransform", u, shuffle.bc3_untransform_plain(t, *args),
                    f"n={n} {s}")
            compare("dlt_bc3_untransform", u, x, f"n={n} {s} round trip")
        for label, (akeys, ckeys) in bc3_keys.items():
            alpha, colour = regions.bc3_regions(x, akeys, ckeys)
            want_alpha, want_colour = regions.bc3_regions_plain(x, akeys, ckeys)
            compare("dlt_bc3_regions", alpha, want_alpha, f"n={n} {label} alpha")
            compare("dlt_bc3_regions", colour, want_colour, f"n={n} {label} colour")
            for rows in (alpha, colour):
                length = rows.shape[1]
                for valid in sorted({length, max(length - 5, 0)}):
                    compare_counts(rows, valid, ks,
                                   f"BC3 n={n} {label} valid_len={valid}")
        checked.append(n)
    # the count kernel's far instantiation: the main file's BC3 rows, and rows that
    # repeat with periods beyond the halo so that the far offsets match
    far_rows = [alpha, colour]
    length = 140_002
    for period in (4097, 8192, 65536):
        row = np.tile(rng.integers(0, 256, period, np.uint8), length // period + 1)
        row = row[:length].copy()
        noise = rng.random(length) < 0.2
        row[noise] = rng.integers(0, 3, int(noise.sum()))
        far_rows.append(torch.from_numpy(row)[None, :].to(dev))
    far_counts = []
    for rows in far_rows:
        for offsets in (FAR_OFFSETS, LADDER_40):
            compare_counts(rows, rows.shape[1], offsets,
                           f"far ladder of {len(offsets)}, rows {tuple(rows.shape)}")
            far_counts.append(int(cuda_ltu.ltu_counts(
                rows, rows.shape[1], offsets,
                [offset_weight(k) for k in offsets]).sum()))
    # inputs shorter than one block, through the entry points
    for size in range(1, 16):
        if size < 8 and auto.transform_bc1_auto(bytes(size), LtuEstimation()) != \
                (b"", BC1_FAST_CANDIDATES[-1]):
            fail(f"BC1 auto-transform of {size} bytes")
        if auto.transform_bc3_auto(bytes(size), LtuEstimation(), True) != \
                (b"", BC3_COMPREHENSIVE_CANDIDATES[-1]):
            fail(f"BC3 auto-transform of {size} bytes")
    emit("check", t0, block_counts=checked, max_abs_err=max_err,
         far_counts=far_counts, launches=dict(backend.LAUNCHES))

    # ---- 4. the main path, through the entry points ---------------------------------
    t0 = time.perf_counter()
    handler = DdsHandler()
    bundles = {
        ("BC1", "fast"): TransformBundle(bc1=Bc1AutoTransformBuilder(LtuEstimation())),
        ("BC1", "comprehensive"): TransformBundle(
            bc1=Bc1AutoTransformBuilder.new_ultra(LtuEstimation())),
        ("BC3", "fast"): TransformBundle(bc3=Bc3AutoTransformBuilder(LtuEstimation())),
        ("BC3", "comprehensive"): TransformBundle(
            bc3=Bc3AutoTransformBuilder.new_ultra(LtuEstimation())),
    }
    sync()
    backend.reset_launch_counts()
    wall = {}
    outs = {}
    for (fmt, label), bundle in bundles.items():
        t = time.perf_counter()
        outs[fmt, label] = handler.transform_bundle(dds[fmt], bundle)
        wall[f"{fmt}_transform_{label}_s"] = time.perf_counter() - t
        t = time.perf_counter()
        back = handler.untransform(outs[fmt, label])
        wall[f"{fmt}_untransform_{label}_s"] = time.perf_counter() - t
        if back != dds[fmt]:
            fail(f"{fmt} {label}: the untransformed file differs from the input")
    sync()
    launches = dict(backend.LAUNCHES)
    if any(count == 0 for count in launches.values()):
        fail(f"a kernel was not launched on the main path: {launches}")
    results = {}
    xs = {fmt: backend.upload(data, dev) for fmt, data in payload.items()}
    for (fmt, label), out in outs.items():
        ref = REFERENCE[fmt][label]
        header = TransformHeader.from_bytes(out)
        if fmt == "BC1":
            cand = BC1_FAST_CANDIDATES if label == "fast" else BC1_COMPREHENSIVE_CANDIDATES
            pick = header.bc1_settings()
            pick_key = (int(pick.decorrelation_mode), pick.split_colour_endpoints)
            scores = auto.candidate_scores(xs[fmt], LtuEstimation(), cand)
        else:
            cand = BC3_FAST_CANDIDATES if label == "fast" else BC3_COMPREHENSIVE_CANDIDATES
            pick = header.bc3_settings()
            pick_key = (int(pick.decorrelation_mode), pick.split_alpha_endpoints,
                        pick.split_colour_endpoints)
            scores = auto.bc3_candidate_scores(xs[fmt], LtuEstimation(), cand)
        scores = [int(v) for v in scores]
        digest = hashlib.sha256(out).hexdigest()
        results[f"{fmt}/{label}"] = {"pick": list(pick_key), "scores": scores,
                                     "sha256": digest}
        if scores != ref["scores"]:
            fail(f"{fmt} {label}: scores {scores} != reference {ref['scores']}")
        if pick_key != ref["pick"]:
            fail(f"{fmt} {label}: pick {pick} != reference {ref['pick']}")
        if digest != ref["sha256"]:
            fail(f"{fmt} {label}: transformed file sha256 differs from the JAX package's")
    emit("main", t0, file_bytes={fmt: len(d) for fmt, d in dds.items()},
         payload_bytes={fmt: len(p) for fmt, p in payload.items()}, blocks=BLOCKS,
         launches=launches, results=results, wall=wall)

    # ---- 5. times ----------------------------------------------------------------------
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def event_ms(fn, iters: int) -> float:
        """Median CUDA-event time of ``fn``, with L2 flushed before each run."""
        fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def compares_needed(r: torch.Tensor, valid: int) -> int:
        """Gram compares the scorer makes on these rows: for each position, up to and
        including its first matching offset, or every offset it reaches."""
        m = valid - 3
        b = r[:, :valid].to(torch.int64)
        g = b[:, :m] | (b[:, 1:m + 1] << 8) | (b[:, 2:m + 2] << 16) | (b[:, 3:m + 3] << 24)
        reach = torch.searchsorted(torch.tensor(ks, device=r.device),
                                   torch.arange(m, device=r.device), right=True)
        tried = reach.expand(r.shape[0], m).clone()
        for o in reversed(range(len(ks))):
            k = ks[o]
            hit = g[:, k:] == g[:, :-k]
            tried[:, k:] = torch.where(hit, o + 1, tried[:, k:])
        return int(tried.sum())

    def time_counts(r: torch.Tensor, valid: int) -> dict:
        positions, compares = r.shape[0] * (valid - 3), compares_needed(r, valid)
        return dict(
            ms=event_ms(lambda: cuda_ltu.ltu_counts(r, valid, ks, ws), 20),
            plain_ms=event_ms(lambda: cuda_ltu.ltu_counts_plain(r, valid, ks, ws), 3),
            score_ms=event_ms(lambda: coverage_scores(r, valid), 10),
            bytes=r.shape[0] * valid, positions=positions, compares=compares,
            ops=OPS_GRAM * positions + OPS_COMPARE * compares,
            issue_ms=(SASS_PER_POSITION * positions + SASS_PER_COMPARE * compares)
            / int_rate * 1e3)

    # the host side of one transform and one untransform of each file, and the
    # copies of its payload apart: medians of 5, before the kernel timings below
    # fill the allocator's cache with their scratch
    def host_s(fn) -> float:
        times = []
        for _ in range(5):
            start = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - start)
        return statistics.median(times)

    # the search alone (regions and scores, without the copies and the transform),
    # and a fresh pinned staging buffer of the payload's size, as upload and
    # download each take one
    search = {"BC1": lambda x: auto.candidate_scores(x, LtuEstimation(),
                                                     BC1_FAST_CANDIDATES),
              "BC3": lambda x: auto.bc3_candidate_scores(x, LtuEstimation(),
                                                         BC3_FAST_CANDIDATES)}
    copies = {}
    for fmt in ("BC1", "BC3"):
        xt = xs[fmt]
        copies[f"{fmt}_h2d_payload_s"] = host_s(lambda: backend.upload(payload[fmt], dev))
        copies[f"{fmt}_d2h_payload_s"] = host_s(lambda: backend.download(xt))
        copies[f"{fmt}_pinned_buffer_s"] = host_s(lambda: torch.empty(
            len(payload[fmt]), dtype=torch.uint8, pin_memory=True))
        copies[f"{fmt}_search_fast_s"] = host_s(lambda: search[fmt](xt))
        # the handler's own bytes work: cutting the payload out of the file, and
        # putting header, payload and tail back together
        copies[f"{fmt}_slice_s"] = host_s(lambda: dds[fmt][0x80:0x80 + len(payload[fmt])])
        copies[f"{fmt}_assemble_s"] = host_s(
            lambda: dds[fmt][:4] + dds[fmt][4:0x80] + payload[fmt] + dds[fmt][len(dds[fmt]):])
        copies[f"{fmt}_transform_fast_file_s"] = host_s(
            lambda: handler.transform_bundle(dds[fmt], bundles[fmt, "fast"]))
        copies[f"{fmt}_untransform_file_s"] = host_s(
            lambda: handler.untransform(outs[fmt, "fast"]))

    n = BLOCKS
    timed = {}
    # BC1: the pick of both candidate sets, variant 1 split
    x = xs["BC1"]
    v, sp = 1, True
    t = shuffle.bc1_transform(x, v, sp)
    timed["dlt_bc1_transform"] = dict(
        ms=event_ms(lambda: shuffle.bc1_transform(x, v, sp), 20),
        plain_ms=event_ms(lambda: shuffle.bc1_transform_plain(x, v, sp), 5),
        bytes=16 * n, ops=OPS_PAIR * n)
    timed["dlt_bc1_untransform"] = dict(
        ms=event_ms(lambda: shuffle.bc1_untransform(t, v, sp), 20),
        plain_ms=event_ms(lambda: shuffle.bc1_untransform_plain(t, v, sp), 5),
        bytes=16 * n, ops=OPS_PAIR * n)
    for label, key in bc1_keys.items():
        c = len(key)
        timed[f"dlt_bc1_regions/{label}"] = dict(
            ms=event_ms(lambda: regions.bc1_regions(x, key), 20),
            plain_ms=event_ms(lambda: regions.bc1_regions_plain(x, key), 5),
            bytes=8 * n + 4 * n * c, ops=3 * OPS_PAIR * n + 4 * c * n)
        timed[f"dlt_ltu_counts/{label}"] = time_counts(regions.bc1_regions(x, key),
                                                       4 * n)
    # BC3: the pick of both candidate sets, variant 1, split alpha, split colour
    x3 = xs["BC3"]
    args3 = (1, True, True)
    t3 = shuffle.bc3_transform(x3, *args3)
    timed["dlt_bc3_transform"] = dict(
        ms=event_ms(lambda: shuffle.bc3_transform(x3, *args3), 20),
        plain_ms=event_ms(lambda: shuffle.bc3_transform_plain(x3, *args3), 5),
        bytes=32 * n, ops=OPS_PAIR * n)
    timed["dlt_bc3_untransform"] = dict(
        ms=event_ms(lambda: shuffle.bc3_untransform(t3, *args3), 20),
        plain_ms=event_ms(lambda: shuffle.bc3_untransform_plain(t3, *args3), 5),
        bytes=32 * n, ops=OPS_PAIR * n)
    for label, (akeys, ckeys) in bc3_keys.items():
        a, k = len(akeys), len(ckeys)
        timed[f"dlt_bc3_regions/{label}"] = dict(
            ms=event_ms(lambda: regions.bc3_regions(x3, akeys, ckeys), 20),
            plain_ms=event_ms(lambda: regions.bc3_regions_plain(x3, akeys, ckeys), 5),
            bytes=16 * n + 2 * n * a + 4 * n * k,
            ops=3 * OPS_PAIR * n + 4 * (a + k) * n)
        alpha, colour = regions.bc3_regions(x3, akeys, ckeys)
        timed[f"dlt_ltu_counts/bc3_alpha_{label}"] = time_counts(alpha, 2 * n)
        timed[f"dlt_ltu_counts/bc3_colour_{label}"] = time_counts(colour, 4 * n)
    for entry in timed.values():
        bytes_ms = entry["bytes"] / rate * 1e3
        ops_ms = entry["ops"] / int_rate * 1e3
        entry["bound_ms"] = max(bytes_ms, ops_ms)
        entry["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"

    emit("times", t0, kernels=timed, host=copies,
         note="kernel ms: CUDA-event medians with L2 flushed before each launch; "
              "host s: medians of 5")

    # ---- 6. the contract lines ----------------------------------------------------------
    # the row of each kernel: its COMPREHENSIVE shape where it has one, and the count
    # kernel on the BC1 COMPREHENSIVE colour rows, as in earlier runs
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = timed.get(name) or timed[f"{name}/comprehensive"]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": entry["ms"], "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
            "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
