#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dxt_lossless_transform_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as a JSON line with its wall time:

1. device: the card as ``nvidia-smi`` names it, its power limit, the PyTorch build,
   and the zstd library that the BC7/BC6H identity guard loads (its path and
   ``ZSTD_versionNumber()``);
2. build: the one ``nvcc`` call that builds the eighteen kernel entry points from
   the six sources ``csrc/bc1_kernels.cu``, ``bc2_kernels.cu``, ``bc3_kernels.cu``,
   ``bc45_kernels.cu``, ``bc7_kernels.cu`` and ``rgb_kernels.cu`` into one library
   under ``build/cuda/`` (skipped when that library is already built);
3. check: each kernel against its plain PyTorch version, both on the card, byte for
   byte and for scores as exact integers: every setting (8 for BC1 and BC2, 16 for
   BC3, 2 for BC4 and BC5), n in {1, 3, 2048, 1,398,103} blocks, the FAST and
   COMPREHENSIVE candidate sets; the count kernel also on offsets beyond its
   4096-byte halo, on a 40-offset ladder and on 70,000 rows (more than a launch's
   grid.y holds); inputs shorter than one block through every auto-search; the
   BC7/BC6H mode-sort kernels for all 4 settings of both formats, n in {1, 2, 3,
   4095, 4096, 4097, 1,398,103}, on realistic BC7 blocks and on random blocks with
   some byte 0 forced to 0; the identity guard's two outcomes on a small input;
   empty and unaligned input through both mode-sort auto-searches; the RGB channel
   kernels for the three non-identity settings of RGBA8888, BGRA8888 and BGR888,
   both directions, n in {1, 2, 3, 4, 5, 4095, 4096, 4097, 16,777,216} pixels, with
   input and output rows at byte offsets 1-3 into larger tensors, and the count
   kernel on their candidate rows at odd n; empty, unaligned and shorter-than-a-pixel
   input through the RGB auto-search;
4. main: the production path through the entry points a user calls, one path per
   format: a 4096x4096 DDS file of each of BC1-BC5, BC7 and BC6H, each with its full
   13-level mip chain (1,398,103 blocks; payloads of 11,184,824 bytes for BC1 and
   BC4 and 22,369,648 for the others), auto-transformed under the LTU estimator
   (with the FAST and the COMPREHENSIVE candidates for BC1-BC3; BC7 and BC6H also
   through the manual default, sort and planes), then untransformed; and a
   4096x4096 RGBA8888, BGRA8888 and BGR888 file each (one level, payloads of
   67,108,864, 67,108,864 and 50,331,648 bytes), written to a temporary directory
   and transformed file to file through ``transform_file_with_multiple_handlers``
   with the RGB auto builders under LTU, then through ``TransformBundle.default_all()``
   (decorrelate and split), each untransformed file to file. The files must come
   back byte-identical, and the picks, the exact integer scores, the identity
   guard's decision and the transformed files' sha256 must equal the JAX package's
   (constants below). The launch counts are set to 0 just before each path and read
   just after it; every kernel of the path must have been launched in it (an RGB
   file's load path launches nothing when the identity wins);
5. times: CUDA-event medians of each kernel at the main path's shapes beside its
   plain version and its bound (the mode-sort kernels in every setting, with the
   ``.t().contiguous()`` call that computes the planes-only layout; the RGB kernels
   in every setting of each layout, with the same call for the split-only layout;
   the count kernel on each RGB file's four candidate rows), and the wall time of
   one transform and one untransform of each file, with the host<->device copies,
   the search, the identity guard's zstd time and the RGB files' reads and writes
   shown apart.

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
import tempfile
import time
from pathlib import Path

TIME_LIMIT_S = 1100

# Reference constants, from the JAX package's exact integer scorer on the same files
# (for BC3 a candidate's score is its alpha region's plus its colour region's; for
# BC4 and BC5 the candidates are split_endpoints true, then false, scored on their
# endpoint streams):
#     JAX_PLATFORMS=cpu python scripts/torch_port_reference.py
SIZE, MIPS, SEED = 4096, 13, 7
BLOCKS = 1398103
FILE_SHA256 = {"BC1": "e07169bacbb49da01c672e1141cf4975372d92b352185762f0b108300f56f94f",
               "BC2": "4cdee0db42ff5be5ff66b3fd2d60bf38d539cd98d6bdf910d8b2a56fa0dfb970",
               "BC3": "4063e4a3827e3234aa1cf9f86908037d1206107059e07821d9b50a3b3d47feab",
               "BC4": "cffd267cec6ad6125aa13856ec4c57e5e4f38074751e17783900778ad626b4f5",
               "BC5": "7dfa7cd1c740e967808fd0aa6a8bcab92ee035c1aa910a69dd9af10bcfefac29"}
FORMATS = ("BC1", "BC2", "BC3", "BC4", "BC5")
BLOCK_SIZE = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16}
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
    "BC2": {
        "fast": {"scores": [132521388, 131980904, 132369283, 131964940],
                 "pick": (1, True),
                 "sha256": "515081da7ec93976be51372477325e3a3063f0f8e208bc94dcdfb762e2a116bd"},
        "comprehensive": {"scores": [132434502, 132521388, 131980904, 132370408,
                                     131967433, 131996919, 132369283, 131964940],
                          "pick": (1, True),
                          "sha256": "515081da7ec93976be51372477325e3a3063f0f8e208bc94dcdfb762e2a116bd"},
    },
    # the JAX package's own search picks split_endpoints=True for BC5: its device
    # scorer sums the 5.6 MB rows in f32, and the exact scores differ by 2
    "BC4": {"auto": {"scores": [67305488, 67305494], "pick": (True,),
                     "sha256": "cf0e3da0aae5f402f259ec56ce09db98dcd845dfc4f3efd9325c162cec9c30df"}},
    "BC5": {"auto": {"scores": [134414433, 134414431], "pick": (False,),
                     "sha256": "a7fcd80c34fdb565a8040fea963d909e6092bc10182d80f4a67f89ba35fdddf8"}},
    # BC7 and BC6H: the FAST candidates (identity, sort, planes, sort+planes), each
    # scored on its whole transformed stream; the guard's decision on the exact
    # pick and the shipped (sort, planes); "manual" is the default, sort and planes
    "BC7": {"auto": {"scores": [537045101, 553517981, 528576344, 520098018],
                     "pick": (True, True), "guard": "kept", "shipped": (True, True),
                     "sha256": "449ef473e483f1b69656bc5e96219ff59d45462b3361adedb9651d28b1a1b96d"},
            "manual": {"sha256": "449ef473e483f1b69656bc5e96219ff59d45462b3361adedb9651d28b1a1b96d"}},
    "BC6H": {"auto": {"scores": [537068095, 553808485, 537068097, 553778264],
                      "pick": (False, False), "guard": "not applied",
                      "shipped": (False, False),
                      "sha256": "242eab760742c1d7a58c66bd5267c83a606f457d58ee77ae5f1b57312500f313"},
             "manual": {"sha256": "cbcd79b983acffc1ba82e8471e00cac9c681eb0a7e6d3816ec6fc23d3439568c"}},
}
# the BC7 and BC6H files: DX10 headers, BC7's payload realistic, BC6H's uniform
# random blocks
MODE_SORT = ("BC7", "BC6H")
MODE_SORT_SHA256 = {
    "BC7": "aa2b2dfc9902e6e846d115579d2e5f4d6f3405e4ace17deaed619a8d0f2fa949",
    "BC6H": "4bda99af0ec06fb96c93b34e07f7394919281f1caeb87dda5fd480a89f6144bc"}
# The uncompressed files: make_uncompressed_dds(layout, 4096, 4096, seed=7), one
# level. The FAST candidates (identity, decorrelate, split, decorrelate+split), each
# scored on its whole transformed stream; the pick as (decorrelate, split);
# "default_all" is the sha256 of the file TransformBundle.default_all() writes
# (decorrelate and split). The JAX package's own search picks the same on all three.
RGB = ("RGBA8888", "BGRA8888", "BGR888")
RGB_PIXELS = SIZE * SIZE
RGB_SHA256 = {
    "RGBA8888": "e03b0fe4687eaaeb92c0b79b1e3213a1e5f8b4cbfba5e9a262e24376af0dad80",
    "BGRA8888": "3103925193010c8cf3e2ce8940f7223efd7a27a74ae4cb732a7f6d11f1e91bc0",
    "BGR888": "ed7065f9efc4c6f9b872568707f1cba674ad21dc225b75e6215c987e7ae9facd"}
RGB_REFERENCE = {
    "RGBA8888": {"scores": [1596437097, 1598482730, 1206520930, 1207306008],
                 "pick": (False, True),
                 "sha256": "9656b21a6ae1f0bfeaf5c609ebf53061c49f1d14781dc38b72874419e465f43c",
                 "default_all": "17fe343433e4af1a43ee955ef1762f2a549cc229212a8431845a7972f144a868"},
    "BGRA8888": {"scores": [1596437097, 1598482730, 1206520930, 1207306008],
                 "pick": (False, True),
                 "sha256": "c611b81764cdc77c6085bb645447f2ac0c1ce9d6187e7427eaab54928fdda3f3",
                 "default_all": "78e4f2bf21281426f2c0ea6ff44aa3dc7138a8076dbfa77fe1b1181a809a2f5d"},
    "BGR888": {"scores": [1207619722, 1207718637, 1206520834, 1207305912],
               "pick": (False, True),
               "sha256": "567fbfea0e8f38033639fc7714f4845943db092cd2fb805bac2c431532f48409",
               "default_all": "45b33b526b029d5c15d11b800b8abcd4226c7bd606fc7346c40ee10f32b9e2b4"},
}
# the RGB kernels' pixel counts in the check phase, and their non-identity settings
RGB_SIZES = (1, 2, 3, 4, 5, 4095, 4096, 4097, RGB_PIXELS)
RGB_SETTINGS = ((True, True), (True, False), (False, True))
# (input, output) byte offsets of the checked rows
RGB_OFFSETS = ((0, 0), (1, 2), (2, 3), (3, 1))

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
    "dlt_bc2_transform": ("bc2_kernels.cu",
                          "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:218"),
    "dlt_bc2_untransform": ("bc2_kernels.cu",
                            "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:245"),
    "dlt_bc2_regions": ("bc2_kernels.cu",
                        "dxt_lossless_transform_tpu/ops/pallas/regions.py:83"),
    "dlt_bc4_transform": ("bc45_kernels.cu",
                          "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:420"),
    "dlt_bc4_untransform": ("bc45_kernels.cu",
                            "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:443"),
    "dlt_bc5_transform": ("bc45_kernels.cu",
                          "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:471"),
    "dlt_bc5_untransform": ("bc45_kernels.cu",
                            "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:501"),
    # also planes.py:46, :77 and :139 (split_planes_tpu, split_planes_flat_tpu,
    # weave_cols_tpu)
    "dlt_bc7_transform": ("bc7_kernels.cu",
                          "dxt_lossless_transform_tpu/ops/pallas/planes.py:280"),
    # also planes.py:218 and :186 (merge_planes_tpu, split_cols_tpu)
    "dlt_bc7_untransform": ("bc7_kernels.cu",
                            "dxt_lossless_transform_tpu/ops/pallas/planes.py:116"),
    # also channels.py:158 (split_bgr_tpu)
    "dlt_rgb_transform": ("rgb_kernels.cu",
                          "dxt_lossless_transform_tpu/ops/pallas/channels.py:58"),
    # also channels.py:197 (merge_bgr_tpu)
    "dlt_rgb_untransform": ("rgb_kernels.cu",
                            "dxt_lossless_transform_tpu/ops/pallas/channels.py:92"),
}
# the kernels of each format's path: its shuffles, its region kernel if it has one,
# and the count kernel that scores every auto-search; BC6H shares BC7's kernels
PATH_KERNELS = {fmt: [name for name in KERNELS if name.startswith(f"dlt_{fmt.lower()}_")]
                + ["dlt_ltu_counts"] for fmt in FORMATS + ("BC7",)}
PATH_KERNELS["BC6H"] = PATH_KERNELS["BC7"]
RGB_KERNELS = ("dlt_rgb_transform", "dlt_rgb_untransform", "dlt_ltu_counts")
# the mode-sort kernels' block counts in the check phase
MODE_SORT_SIZES = (1, 2, 3, 4095, 4096, 4097, BLOCKS)
# rows for the count kernel's many-rows case: more than one launch's grid.y (65,535)
MANY_ROWS = 70_000
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
# and, from csrc/bc7_kernels.cu, 24 per block to find its mode id, rank it (match,
# two population counts, table reads and adds) and pack its nibble, when sorting
OPS_MODE_SORT = 24
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
        Bc1AutoTransformBuilder, Bc2AutoTransformBuilder, Bc3AutoTransformBuilder,
        Bc4AutoTransformBuilder, Bc5AutoTransformBuilder, Bc6hAutoTransformBuilder,
        Bc6hManualTransformBuilder, Bc7AutoTransformBuilder, Bc7ManualTransformBuilder,
        RgbAutoTransformBuilder,
    )
    from dxt_lossless_transform_tpu_torch.errors import (
        Bc6hValidationError, Bc7ValidationError, RgbValidationError,
    )
    from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu, zstd
    from dxt_lossless_transform_tpu_torch.estimate.ltu import (
        DEFAULT_OFFSETS, LtuEstimation, coverage_scores, offset_weight,
    )
    from dxt_lossless_transform_tpu_torch.formats import file_io
    from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
    from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
    from dxt_lossless_transform_tpu_torch.ops import auto, bc45, bc6h, bc7, rgb
    from dxt_lossless_transform_tpu_torch.ops.cuda import channels, planes, regions, shuffle
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
        BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
        BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, RGB_FAST_CANDIDATES,
        Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
        Bc4TransformSettings, Bc5TransformSettings, Bc7TransformSettings,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import (
        bc7_realistic, bc_blocks, make_dds, make_dx10_dds, make_uncompressed_dds,
    )

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    run_start = time.perf_counter()

    # ---- 1. device ------------------------------------------------------------------
    t0 = time.perf_counter()
    # the library the BC7/BC6H identity guard compresses with, first
    zstd_library, zstd_version = zstd.library_path(), zstd.version()
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
         int32_ops_rate=int_rate, zstd_library=zstd_library, zstd_version=zstd_version)

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
    dds = {fmt: make_dds(fmt, SIZE, SIZE, MIPS, seed=SEED) for fmt in FORMATS}
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
    bc2_keys = {label: auto.colour_keys(cand)[0]
                for label, cand in (("fast", BC2_FAST_CANDIDATES),
                                    ("comprehensive", BC2_COMPREHENSIVE_CANDIDATES))}
    # BC4 and BC5: (kernel, plain) for each direction, and endpoint bytes per block
    bc45_kernels = {
        "BC4": ((shuffle.bc4_transform, shuffle.bc4_transform_plain),
                (shuffle.bc4_untransform, shuffle.bc4_untransform_plain), 2),
        "BC5": ((shuffle.bc5_transform, shuffle.bc5_transform_plain),
                (shuffle.bc5_untransform, shuffle.bc5_untransform_plain), 4)}
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
        x = backend.upload(payload["BC2"] if n == BLOCKS
                           else rng.integers(0, 256, 16 * n, np.uint8).tobytes(), dev)
        for s in Bc2TransformSettings.all_combinations():
            v, sp = int(s.decorrelation_mode), s.split_colour_endpoints
            t = shuffle.bc2_transform(x, v, sp)
            compare("dlt_bc2_transform", t, shuffle.bc2_transform_plain(x, v, sp),
                    f"n={n} {s}")
            u = shuffle.bc2_untransform(t, v, sp)
            compare("dlt_bc2_untransform", u, shuffle.bc2_untransform_plain(t, v, sp),
                    f"n={n} {s}")
            compare("dlt_bc2_untransform", u, x, f"n={n} {s} round trip")
        for label, key in bc2_keys.items():
            rows = regions.bc2_regions(x, key)
            compare("dlt_bc2_regions", rows, regions.bc2_regions_plain(x, key),
                    f"n={n} {label}")
            for valid in sorted({4 * n, max(4 * n - 5, 0)}):
                compare_counts(rows, valid, ks, f"BC2 n={n} {label} valid_len={valid}")
        for fmt, ((t_kernel, t_plain), (u_kernel, u_plain), ep) in bc45_kernels.items():
            size = BLOCK_SIZE[fmt]
            x = backend.upload(payload[fmt] if n == BLOCKS
                               else rng.integers(0, 256, size * n, np.uint8).tobytes(),
                               dev)
            name = f"dlt_{fmt.lower()}"
            prefixes = []
            for split in (True, False):
                t = t_kernel(x, split)
                compare(f"{name}_transform", t, t_plain(x, split), f"n={n} split={split}")
                u = u_kernel(t, split)
                compare(f"{name}_untransform", u, u_plain(t, split),
                        f"n={n} split={split}")
                compare(f"{name}_untransform", u, x, f"n={n} split={split} round trip")
                prefixes.append(t[:ep * n])
            compare_counts(torch.stack(prefixes), ep * n, ks,
                           f"{fmt} n={n} endpoint rows")
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
    # more rows than one launch's grid.y holds: the entry point launches per group
    many = torch.from_numpy(rng.integers(0, 3, (MANY_ROWS, 12), np.uint8)).to(dev)
    compare_counts(many, 12, ks, f"{MANY_ROWS} rows of 12 bytes")
    many_rows_sum = int(cuda_ltu.ltu_counts(many, 12, ks, ws).sum())
    # inputs shorter than one block, through the entry points
    short = {"BC1": (lambda d: auto.transform_bc1_auto(d, LtuEstimation()),
                     BC1_FAST_CANDIDATES[-1]),
             "BC2": (lambda d: auto.transform_bc2_auto(d, LtuEstimation(), True),
                     BC2_COMPREHENSIVE_CANDIDATES[-1]),
             "BC3": (lambda d: auto.transform_bc3_auto(d, LtuEstimation(), True),
                     BC3_COMPREHENSIVE_CANDIDATES[-1]),
             "BC4": (lambda d: bc45.transform_bc4_auto(d, LtuEstimation()),
                     Bc4TransformSettings(False)),
             "BC5": (lambda d: bc45.transform_bc5_auto(d, LtuEstimation()),
                     Bc5TransformSettings(False))}
    for fmt, (search, last) in short.items():
        for size in range(1, BLOCK_SIZE[fmt]):
            if search(bytes(size)) != (b"", last):
                fail(f"{fmt} auto-transform of {size} bytes")
    # the BC7/BC6H mode-sort kernels: every setting of both formats, on realistic BC7
    # blocks and on random blocks with byte 0 forced to 0 (BC7's invalid id 8) in
    # about one block in eight
    ms_dds = {"BC7": make_dx10_dds("BC7", SIZE, SIZE, MIPS, seed=SEED),
              "BC6H": make_dx10_dds("BC6H", SIZE, SIZE, MIPS,
                                    payload=bc_blocks(BLOCKS, 16, SEED))}
    for fmt, data in ms_dds.items():
        if hashlib.sha256(data).hexdigest() != MODE_SORT_SHA256[fmt]:
            fail(f"make_dx10_dds gave another {fmt} file than the reference run")
    ms_payload = {fmt: data[0x94:] for fmt, data in ms_dds.items()}
    ms_fmt = {"BC7": planes.BC7, "BC6H": planes.BC6H}
    settings_4 = tuple((s.sort_by_mode, s.split_byte_planes)
                       for s in Bc7TransformSettings.all_combinations())
    for n in MODE_SORT_SIZES:
        random_blocks = rng.integers(0, 256, (n, 16), np.uint8)
        random_blocks[rng.random(n) < 0.125, 0] = 0
        kinds = {"realistic": ms_payload["BC7"] if n == BLOCKS else bc7_realistic(n, n),
                 "random": random_blocks.tobytes()}
        for data_kind, host in kinds.items():
            x = backend.upload(host, dev)
            for fmt, fmt_id in ms_fmt.items():
                for sort, split in settings_4:
                    what = f"{fmt} n={n} {data_kind} sort={sort} planes={split}"
                    t = planes.bc7_transform(x, fmt_id, sort, split)
                    compare("dlt_bc7_transform", t,
                            planes.bc7_transform_plain(x, fmt_id, sort, split), what)
                    u = planes.bc7_untransform(t, n, sort, split)
                    compare("dlt_bc7_untransform", u,
                            planes.bc7_untransform_plain(t, n, sort, split), what)
                    compare("dlt_bc7_untransform", u, x, f"{what} round trip")
    # the identity guard's two outcomes on a small input: a realistic sort+planes
    # winner is kept, a planes-only winner on random blocks goes back to the identity
    guard_checks = {}
    identity, full = Bc7TransformSettings(False, False), Bc7TransformSettings(True, True)
    for data_kind, host, settings, want in (
            ("realistic", bc7_realistic(5000, SEED), full, "kept"),
            ("random", rng.integers(0, 256, 16 * 5000, np.uint8).tobytes(),
             Bc7TransformSettings(False, True), "identity")):
        out = backend.download(bc7.transform_tensor(backend.upload(host, dev), settings))
        shipped = bc7.ltu_identity_guard(host, out, settings, BC7_FAST_CANDIDATES)
        got = ("kept" if shipped == (out, settings) else
               "identity" if shipped == (host, identity) else "neither")
        guard_checks[data_kind] = got
        if got != want:
            fail(f"identity guard on a {data_kind} input: {got}, expected {want}")
    # the mode-sort searches: empty input gives the last candidate, unaligned input
    # the format's validation error
    for search, cand, error in (
            (bc7.transform_bc7_auto, BC7_FAST_CANDIDATES, Bc7ValidationError),
            (bc6h.transform_bc6h_auto, BC6H_FAST_CANDIDATES, Bc6hValidationError)):
        if search(b"", LtuEstimation()) != (b"", cand[-1]):
            fail(f"{search.__name__} of empty input")
        for size in (1, 15, 17):
            try:
                search(bytes(size), LtuEstimation())
            except error:
                continue
            fail(f"{search.__name__} of {size} bytes did not raise {error.__name__}")
    # the RGB channel kernels: the non-identity settings of each layout, both
    # directions, input and output rows at byte offsets 1-3 into larger tensors (the
    # bytes around them must stay as they were); the main files' payloads at n =
    # 16,777,216
    rgb_dds = {fmt: make_uncompressed_dds(fmt.lower(), SIZE, SIZE, seed=SEED)
               for fmt in RGB}
    for fmt, data in rgb_dds.items():
        if hashlib.sha256(data).hexdigest() != RGB_SHA256[fmt]:
            fail(f"make_uncompressed_dds gave another {fmt} file than the reference run")
    rgb_payload = {fmt: data[0x80:] for fmt, data in rgb_dds.items()}
    rgb_cases = 0
    for fmt in RGB:
        layout = fmt.lower()
        stride = channels.LAYOUTS[layout][0]
        for n_px in RGB_SIZES:
            length = stride * n_px
            x0 = backend.upload(rgb_payload[fmt] if n_px == RGB_PIXELS else
                                rng.integers(0, 256, length, np.uint8).tobytes(), dev)
            for dec, split in RGB_SETTINGS:
                args = (*channels.LAYOUTS[layout], dec, split)
                for in_off, out_off in RGB_OFFSETS:
                    what = (f"{fmt} n={n_px} dec={dec} split={split} offsets "
                            f"{in_off}/{out_off}")
                    x = torch.empty(length + 8, dtype=torch.uint8,
                                    device=dev)[in_off:in_off + length].copy_(x0)
                    buf = torch.full((length + 8,), 0xAB, dtype=torch.uint8, device=dev)
                    t = channels.rgb_transform(x, *args,
                                               out=buf[out_off:out_off + length])
                    compare("dlt_rgb_transform", t,
                            channels.rgb_transform_plain(x, *args), what)
                    back = torch.full((length + 8,), 0xCD, dtype=torch.uint8, device=dev)
                    u = channels.rgb_untransform(t, *args,
                                                 out=back[in_off:in_off + length])
                    compare("dlt_rgb_untransform", u,
                            channels.rgb_untransform_plain(t, *args), what)
                    compare("dlt_rgb_untransform", u, x, f"{what} round trip")
                    sync()
                    if not (bool((buf[:out_off] == 0xAB).all())
                            and bool((buf[out_off + length:] == 0xAB).all())
                            and bool((back[:in_off] == 0xCD).all())
                            and bool((back[in_off + length:] == 0xCD).all())):
                        fail(f"RGB kernels wrote outside their rows: {what}")
                    rgb_cases += 1
            if n_px in (5, 4097):
                # the search's candidate rows, which start unaligned for odd n
                _, rows = rgb.candidate_rows(x0, layout, LtuEstimation(),
                                             RGB_FAST_CANDIDATES)
                rows = torch.stack(list(rows.values()))
                for valid in (length, length - 5):
                    compare_counts(rows, valid, ks, f"{fmt} rows n={n_px} valid={valid}")
    # the RGB search's edge cases: empty input gives the last candidate, a length
    # that is no whole number of pixels (also below one pixel) raises
    for fmt in RGB:
        layout = fmt.lower()
        stride = channels.LAYOUTS[layout][0]
        if rgb.transform_rgb_auto(b"", layout, LtuEstimation()) != \
                (b"", RGB_FAST_CANDIDATES[-1]):
            fail(f"{fmt} auto-transform of empty input")
        for size in list(range(1, stride)) + [stride + 1, 3 * stride + 2]:
            try:
                rgb.transform_rgb_auto(bytes(size), layout, LtuEstimation())
            except RgbValidationError:
                continue
            fail(f"{fmt} auto-transform of {size} bytes did not raise RgbValidationError")
    emit("check", t0, block_counts=checked, max_abs_err=max_err,
         far_counts=far_counts, many_rows=MANY_ROWS, many_rows_count_sum=many_rows_sum,
         mode_sort_block_counts=list(MODE_SORT_SIZES), guard=guard_checks,
         rgb_pixel_counts=list(RGB_SIZES), rgb_cases=rgb_cases,
         launches=dict(backend.LAUNCHES))

    # ---- 4. the main path, through the entry points ---------------------------------
    t0 = time.perf_counter()
    handler = DdsHandler()
    bundles = {
        ("BC1", "fast"): TransformBundle(bc1=Bc1AutoTransformBuilder(LtuEstimation())),
        ("BC1", "comprehensive"): TransformBundle(
            bc1=Bc1AutoTransformBuilder.new_ultra(LtuEstimation())),
        ("BC2", "fast"): TransformBundle(bc2=Bc2AutoTransformBuilder(LtuEstimation())),
        ("BC2", "comprehensive"): TransformBundle(
            bc2=Bc2AutoTransformBuilder.new_ultra(LtuEstimation())),
        ("BC3", "fast"): TransformBundle(bc3=Bc3AutoTransformBuilder(LtuEstimation())),
        ("BC3", "comprehensive"): TransformBundle(
            bc3=Bc3AutoTransformBuilder.new_ultra(LtuEstimation())),
        ("BC4", "auto"): TransformBundle(bc4=Bc4AutoTransformBuilder(LtuEstimation())),
        ("BC5", "auto"): TransformBundle(bc5=Bc5AutoTransformBuilder(LtuEstimation())),
        ("BC7", "auto"): TransformBundle(bc7=Bc7AutoTransformBuilder(LtuEstimation())),
        ("BC7", "manual"): TransformBundle(bc7=Bc7ManualTransformBuilder()),
        ("BC6H", "auto"): TransformBundle(bc6h=Bc6hAutoTransformBuilder(LtuEstimation())),
        ("BC6H", "manual"): TransformBundle(bc6h=Bc6hManualTransformBuilder()),
    }
    dds.update(ms_dds)
    wall = {}
    outs = {}
    path_launches = {}
    for fmt in FORMATS + MODE_SORT:
        # each format's path: its counts set to 0 just before and read just after
        sync()
        backend.reset_launch_counts()
        for (bundle_fmt, label), bundle in bundles.items():
            if bundle_fmt != fmt:
                continue
            t = time.perf_counter()
            outs[fmt, label] = handler.transform_bundle(dds[fmt], bundle)
            wall[f"{fmt}_transform_{label}_s"] = time.perf_counter() - t
            t = time.perf_counter()
            back = handler.untransform(outs[fmt, label])
            wall[f"{fmt}_untransform_{label}_s"] = time.perf_counter() - t
            if back != dds[fmt]:
                fail(f"{fmt} {label}: the untransformed file differs from the input")
        sync()
        path_launches[fmt] = {name: backend.LAUNCHES[name] for name in PATH_KERNELS[fmt]}
        if any(count == 0 for count in path_launches[fmt].values()):
            fail(f"a kernel of the {fmt} path was not launched on it: "
                 f"{path_launches[fmt]}")
        others = {name: count for name, count in backend.LAUNCHES.items()
                  if count and name not in PATH_KERNELS[fmt]}
        if others:
            fail(f"the {fmt} path launched other formats' kernels: {others}")
    # the RGB files, file in, file out: the LTU auto builders, then default_all; each
    # transform and its untransform are one path
    rgb_bundle = TransformBundle(**{fmt.lower(): RgbAutoTransformBuilder(
        fmt.lower(), LtuEstimation()) for fmt in RGB})
    rgb_bundles = {"auto": rgb_bundle, "default_all": TransformBundle.default_all()}
    # removed at the end of the times phase, or by its finalizer when a phase fails
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmpdir = Path(tmp.name)
    rgb_outs = {}
    for fmt in RGB:
        src = tmpdir / f"{fmt}.dds"
        src.write_bytes(rgb_dds[fmt])
        for label, bundle in rgb_bundles.items():
            dst, back = tmpdir / f"{fmt}.{label}.dlt", tmpdir / f"{fmt}.{label}.back.dds"
            sync()
            backend.reset_launch_counts()
            t = time.perf_counter()
            file_io.transform_file_with_multiple_handlers([handler], bundle, src, dst)
            wall[f"{fmt}_transform_{label}_file_s"] = time.perf_counter() - t
            t = time.perf_counter()
            file_io.untransform_file_with_multiple_handlers([handler], dst, back)
            wall[f"{fmt}_untransform_{label}_file_s"] = time.perf_counter() - t
            sync()
            counts = {name: backend.LAUNCHES[name] for name in RGB_KERNELS}
            path_launches[f"{fmt}/{label}"] = counts
            if back.read_bytes() != rgb_dds[fmt]:
                fail(f"{fmt} {label}: the untransformed file differs from the input")
            out = rgb_outs[fmt, label] = dst.read_bytes()
            shipped = TransformHeader.from_bytes(out).rgb_settings()
            needed = ["dlt_rgb_transform"] + (["dlt_ltu_counts"] if label == "auto" else [])
            if shipped.decorrelate or shipped.split_channels:
                needed.append("dlt_rgb_untransform")
            if any(counts[name] == 0 for name in needed):
                fail(f"a kernel of the {fmt} {label} path was not launched on it: {counts}")
            others = {name: count for name, count in backend.LAUNCHES.items()
                      if count and name not in RGB_KERNELS}
            if others:
                fail(f"the {fmt} {label} path launched other formats' kernels: {others}")
    # each kernel's launches on the main path: the count kernel's over every path
    launches = {name: sum(counts.get(name, 0) for counts in path_launches.values())
                for name in KERNELS}
    results = {}
    xs = {fmt: backend.upload(data, dev) for fmt, data in payload.items()}
    xs.update({fmt: backend.upload(data, dev) for fmt, data in ms_payload.items()})
    ms_cand = {"BC7": BC7_FAST_CANDIDATES, "BC6H": BC6H_FAST_CANDIDATES}
    n = BLOCKS
    for (fmt, label), out in outs.items():
        ref = REFERENCE[fmt][label]
        header = TransformHeader.from_bytes(out)
        digest = hashlib.sha256(out).hexdigest()
        if fmt in MODE_SORT:
            shipped = getattr(header, f"{fmt.lower()}_settings")()
            shipped_key = (shipped.sort_by_mode, shipped.split_byte_planes)
            results[f"{fmt}/{label}"] = {"shipped": list(shipped_key), "sha256": digest,
                                         "bytes": len(out)}
            if digest != ref["sha256"]:
                fail(f"{fmt} {label}: transformed file sha256 differs from the JAX "
                     f"package's")
            if label == "manual":
                if shipped_key != (True, True):
                    fail(f"{fmt} manual default shipped {shipped_key}")
                continue
            cand = ms_cand[fmt]
            scores, streams = bc7.candidate_streams(xs[fmt], ms_fmt[fmt], LtuEstimation(),
                                                    cand, fmt)
            scores = [int(v) for v in scores]
            pick = cand[int(np.argmin(scores))]
            pick_key = (pick.sort_by_mode, pick.split_byte_planes)
            guard = ("not applied" if pick_key == (False, False) else
                     "kept" if shipped_key == pick_key else "identity")
            # printed, not held: they may shift with the machine's libzstd
            sizes = zstd.ZstdEstimation(1).estimate_batch(
                [backend.download(streams[c.sort_by_mode, c.split_byte_planes])
                 for c in cand])
            results[f"{fmt}/{label}"].update(scores=scores, pick=list(pick_key),
                                             guard=guard, zstd1_sizes=sizes)
            for key, got in (("scores", scores), ("pick", pick_key), ("guard", guard),
                             ("shipped", shipped_key)):
                if got != ref[key]:
                    fail(f"{fmt} {label}: {key} {got} != reference {ref[key]}")
            continue
        if fmt in ("BC1", "BC2"):
            cand = {("BC1", "fast"): BC1_FAST_CANDIDATES,
                    ("BC1", "comprehensive"): BC1_COMPREHENSIVE_CANDIDATES,
                    ("BC2", "fast"): BC2_FAST_CANDIDATES,
                    ("BC2", "comprehensive"): BC2_COMPREHENSIVE_CANDIDATES}[fmt, label]
            pick = getattr(header, f"{fmt.lower()}_settings")()
            pick_key = (int(pick.decorrelation_mode), pick.split_colour_endpoints)
            scores = (auto.candidate_scores if fmt == "BC1" else
                      auto.bc2_candidate_scores)(xs[fmt], LtuEstimation(), cand)
        elif fmt == "BC3":
            cand = BC3_FAST_CANDIDATES if label == "fast" else BC3_COMPREHENSIVE_CANDIDATES
            pick = header.bc3_settings()
            pick_key = (int(pick.decorrelation_mode), pick.split_alpha_endpoints,
                        pick.split_colour_endpoints)
            scores = auto.bc3_candidate_scores(xs[fmt], LtuEstimation(), cand)
        else:
            settings = Bc4TransformSettings if fmt == "BC4" else Bc5TransformSettings
            pick = getattr(header, f"{fmt.lower()}_settings")()
            pick_key = (pick.split_endpoints,)
            (kernel, _), _, ep = bc45_kernels[fmt]
            scores, _ = bc45.endpoint_scores(fmt, xs[fmt], LtuEstimation(),
                                             tuple(settings.all_combinations()), ep * n,
                                             kernel)
        scores = [int(v) for v in scores]
        results[f"{fmt}/{label}"] = {"pick": list(pick_key), "scores": scores,
                                     "sha256": digest}
        if scores != ref["scores"]:
            fail(f"{fmt} {label}: scores {scores} != reference {ref['scores']}")
        if pick_key != ref["pick"]:
            fail(f"{fmt} {label}: pick {pick} != reference {ref['pick']}")
        if digest != ref["sha256"]:
            fail(f"{fmt} {label}: transformed file sha256 differs from the JAX package's")
    rgb_xs = {fmt: backend.upload(data, dev) for fmt, data in rgb_payload.items()}
    for fmt in RGB:
        ref = RGB_REFERENCE[fmt]
        scores, _ = rgb.candidate_rows(rgb_xs[fmt], fmt.lower(), LtuEstimation(),
                                       RGB_FAST_CANDIDATES)
        scores = [int(v) for v in scores]
        pick = RGB_FAST_CANDIDATES[int(np.argmin(scores))]
        pick_key = (pick.decorrelate, pick.split_channels)
        shipped = TransformHeader.from_bytes(rgb_outs[fmt, "auto"]).rgb_settings()
        shipped_key = (shipped.decorrelate, shipped.split_channels)
        digest = hashlib.sha256(rgb_outs[fmt, "auto"]).hexdigest()
        default_digest = hashlib.sha256(rgb_outs[fmt, "default_all"]).hexdigest()
        results[f"{fmt}/auto"] = {"scores": scores, "pick": list(pick_key),
                                  "shipped": list(shipped_key), "sha256": digest}
        results[f"{fmt}/default_all"] = {"sha256": default_digest}
        for key, got, want in (("scores", scores, ref["scores"]),
                               ("pick", pick_key, ref["pick"]),
                               ("shipped", shipped_key, ref["pick"]),
                               ("sha256", digest, ref["sha256"]),
                               ("default_all sha256", default_digest, ref["default_all"])):
            if got != want:
                fail(f"{fmt}: {key} {got} != reference {want}")
    emit("main", t0, file_bytes={fmt: len(d) for fmt, d in {**dds, **rgb_dds}.items()},
         payload_bytes={fmt: len(p) for fmt, p in
                        {**payload, **ms_payload, **rgb_payload}.items()},
         blocks=BLOCKS, rgb_pixels=RGB_PIXELS,
         launches=path_launches, results=results, wall=wall)

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
    # (BC4 and BC5: both candidates' transforms and their scores)
    search = {"BC1": lambda x: auto.candidate_scores(x, LtuEstimation(),
                                                     BC1_FAST_CANDIDATES),
              "BC2": lambda x: auto.bc2_candidate_scores(x, LtuEstimation(),
                                                         BC2_FAST_CANDIDATES),
              "BC3": lambda x: auto.bc3_candidate_scores(x, LtuEstimation(),
                                                         BC3_FAST_CANDIDATES),
              "BC4": lambda x: bc45.endpoint_scores(
                  "BC4", x, LtuEstimation(), tuple(Bc4TransformSettings.all_combinations()),
                  2 * n, shuffle.bc4_transform),
              "BC5": lambda x: bc45.endpoint_scores(
                  "BC5", x, LtuEstimation(), tuple(Bc5TransformSettings.all_combinations()),
                  4 * n, shuffle.bc5_transform)}
    copies = {}
    for fmt in FORMATS:
        xt = xs[fmt]
        fast = "auto" if fmt in ("BC4", "BC5") else "fast"
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
        copies[f"{fmt}_transform_{fast}_file_s"] = host_s(
            lambda: handler.transform_bundle(dds[fmt], bundles[fmt, fast]))
        copies[f"{fmt}_untransform_file_s"] = host_s(
            lambda: handler.untransform(outs[fmt, fast]))
    # BC7 and BC6H: the search alone (three transform launches into the candidate
    # rows and two scoring calls, unsorted and sorted rows), the identity guard as
    # the search runs it (BC6H: not applied), zstd-1 of the winner and the payload,
    # the download of the winner, and the manual default's transform and untransform
    for fmt in MODE_SORT:
        xt, cand, data = xs[fmt], ms_cand[fmt], ms_payload[fmt]
        scores, streams = bc7.candidate_streams(xt, ms_fmt[fmt], LtuEstimation(), cand,
                                                fmt)
        pick = cand[int(np.argmin(scores))]
        winner = streams[pick.sort_by_mode, pick.split_byte_planes]
        out = backend.download(winner)
        full_out = backend.download(streams[True, True])
        copies[f"{fmt}_h2d_payload_s"] = host_s(lambda: backend.upload(data, dev))
        copies[f"{fmt}_d2h_winner_s"] = host_s(lambda: backend.download(winner))
        copies[f"{fmt}_search_s"] = host_s(lambda: bc7.candidate_streams(
            xt, ms_fmt[fmt], LtuEstimation(), cand, fmt))
        copies[f"{fmt}_guard_s"] = host_s(
            lambda: bc7.ltu_identity_guard(data, out, pick, cand))
        copies[f"{fmt}_zstd1_pair_s"] = host_s(
            lambda: zstd.ZstdEstimation(1).estimate_batch([full_out, data]))
        copies[f"{fmt}_slice_s"] = host_s(lambda: dds[fmt][0x94:0x94 + len(data)])
        copies[f"{fmt}_transform_auto_file_s"] = host_s(
            lambda: handler.transform_bundle(dds[fmt], bundles[fmt, "auto"]))
        copies[f"{fmt}_untransform_auto_file_s"] = host_s(
            lambda: handler.untransform(outs[fmt, "auto"]))
        copies[f"{fmt}_transform_manual_file_s"] = host_s(
            lambda: handler.transform_bundle(dds[fmt], bundles[fmt, "manual"]))
        copies[f"{fmt}_untransform_manual_file_s"] = host_s(
            lambda: handler.untransform(outs[fmt, "manual"]))
    # the RGB files, file to file: reading the input (mmap and copy out) and writing
    # the output, the payload's upload, the search alone (three transform launches
    # into the candidate rows, the identity row's copy and one scoring call), the
    # download of the winner, the handler's slice and join, and the whole transform
    # and untransform through the file API, with the auto builders and default_all
    for fmt in RGB:
        layout, data, xt = fmt.lower(), rgb_payload[fmt], rgb_xs[fmt]
        src, dst, back = (tmpdir / f"{fmt}.dds", tmpdir / f"{fmt}.time.dlt",
                          tmpdir / f"{fmt}.time.back.dds")
        out = rgb_outs[fmt, "auto"]
        _, rows = rgb.candidate_rows(xt, layout, LtuEstimation(), RGB_FAST_CANDIDATES)
        winner = rows[RGB_REFERENCE[fmt]["pick"]]
        copies[f"{fmt}_read_file_s"] = host_s(lambda: file_io._read_mmap(src))
        copies[f"{fmt}_write_file_s"] = host_s(lambda: dst.write_bytes(out))
        copies[f"{fmt}_h2d_payload_s"] = host_s(lambda: backend.upload(data, dev))
        copies[f"{fmt}_search_s"] = host_s(lambda: rgb.candidate_rows(
            xt, layout, LtuEstimation(), RGB_FAST_CANDIDATES))
        copies[f"{fmt}_d2h_winner_s"] = host_s(lambda: backend.download(winner))
        copies[f"{fmt}_slice_s"] = host_s(lambda: rgb_dds[fmt][0x80:0x80 + len(data)])
        copies[f"{fmt}_assemble_s"] = host_s(
            lambda: out[:4] + rgb_dds[fmt][4:0x80] + out[0x80:] + b"")
        for label, bundle in rgb_bundles.items():
            copies[f"{fmt}_transform_{label}_file_s"] = host_s(
                lambda: file_io.transform_file_with_multiple_handlers(
                    [handler], bundle, src, dst))
            copies[f"{fmt}_untransform_{label}_file_s"] = host_s(
                lambda: file_io.untransform_file_with_multiple_handlers(
                    [handler], dst, back))

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
    # BC2: the pick of both candidate sets, variant 1 split
    x2 = xs["BC2"]
    t2 = shuffle.bc2_transform(x2, v, sp)
    timed["dlt_bc2_transform"] = dict(
        ms=event_ms(lambda: shuffle.bc2_transform(x2, v, sp), 20),
        plain_ms=event_ms(lambda: shuffle.bc2_transform_plain(x2, v, sp), 5),
        bytes=32 * n, ops=OPS_PAIR * n)
    timed["dlt_bc2_untransform"] = dict(
        ms=event_ms(lambda: shuffle.bc2_untransform(t2, v, sp), 20),
        plain_ms=event_ms(lambda: shuffle.bc2_untransform_plain(t2, v, sp), 5),
        bytes=32 * n, ops=OPS_PAIR * n)
    for label, key in bc2_keys.items():
        c = len(key)
        timed[f"dlt_bc2_regions/{label}"] = dict(
            ms=event_ms(lambda: regions.bc2_regions(x2, key), 20),
            plain_ms=event_ms(lambda: regions.bc2_regions_plain(x2, key), 5),
            bytes=16 * n + 4 * n * c, ops=3 * OPS_PAIR * n + 4 * c * n)
        timed[f"dlt_ltu_counts/bc2_{label}"] = time_counts(regions.bc2_regions(x2, key),
                                                           4 * n)
    # BC4 and BC5: both settings are the main path's (each search transforms with
    # both); split, as the row of each; pure moves, no arithmetic
    for fmt, ((t_kernel, t_plain), (u_kernel, u_plain), ep) in bc45_kernels.items():
        x45 = xs[fmt]
        t45 = t_kernel(x45, True)
        name = f"dlt_{fmt.lower()}"
        moved = 2 * BLOCK_SIZE[fmt] * n
        timed[f"{name}_transform"] = dict(
            ms=event_ms(lambda: t_kernel(x45, True), 20),
            plain_ms=event_ms(lambda: t_plain(x45, True), 5), bytes=moved, ops=0)
        timed[f"{name}_untransform"] = dict(
            ms=event_ms(lambda: u_kernel(t45, True), 20),
            plain_ms=event_ms(lambda: u_plain(t45, True), 5), bytes=moved, ops=0)
        rows = torch.stack([t_kernel(x45, True)[:ep * n], t_kernel(x45, False)[:ep * n]])
        timed[f"dlt_ltu_counts/{fmt.lower()}_endpoints"] = time_counts(rows, ep * n)
    # BC7 and BC6H: each setting that launches, on each file with its format; the
    # planes-only layout beside the one PyTorch call that computes it
    msl = (n + 1) // 2
    for fmt in MODE_SORT:
        xm, fmt_id = xs[fmt], ms_fmt[fmt]
        for sort, split in settings_4:
            if not (sort or split):
                continue
            label = f"{fmt.lower()}_{'sort_' if sort else ''}{'planes' if split else 'blocks'}"
            tm = planes.bc7_transform(xm, fmt_id, sort, split)
            moved = 32 * n + (msl if sort else 0)
            ops = OPS_MODE_SORT * n if sort else 0
            timed[f"dlt_bc7_transform/{label}"] = dict(
                ms=event_ms(lambda: planes.bc7_transform(xm, fmt_id, sort, split), 20),
                plain_ms=event_ms(
                    lambda: planes.bc7_transform_plain(xm, fmt_id, sort, split), 5),
                bytes=moved, ops=ops)
            timed[f"dlt_bc7_untransform/{label}"] = dict(
                ms=event_ms(lambda: planes.bc7_untransform(tm, n, sort, split), 20),
                plain_ms=event_ms(
                    lambda: planes.bc7_untransform_plain(tm, n, sort, split), 5),
                bytes=moved, ops=ops)
            if not sort:
                timed[f"dlt_bc7_transform/{label}"]["library_ms"] = event_ms(
                    lambda: xm.view(n, 16).t().contiguous(), 20)
                timed[f"dlt_bc7_untransform/{label}"]["library_ms"] = event_ms(
                    lambda: tm.view(16, n).t().contiguous(), 20)
        # the search's two scoring calls: the unsorted and the sorted rows
        _, streams = bc7.candidate_streams(xm, fmt_id, LtuEstimation(),
                                           ms_cand[fmt], fmt)
        for sort in (False, True):
            rows = torch.stack([streams[sort, split] for split in (False, True)])
            timed[f"dlt_ltu_counts/{fmt.lower()}_{'sorted' if sort else 'unsorted'}"] = \
                time_counts(rows, rows.shape[1])
    # RGB: both entry points in each non-identity setting of each layout at the main
    # files' 16,777,216 pixels, the split-only layout beside the one PyTorch call that
    # computes it; bytes S*n each way, and two per-byte SIMD ops per 4 pixels for the
    # lifting; the count kernel on each file's four candidate rows
    for fmt in RGB:
        layout, xr = fmt.lower(), rgb_xs[fmt]
        stride = channels.LAYOUTS[layout][0]
        for dec, split in RGB_SETTINGS:
            args = (*channels.LAYOUTS[layout], dec, split)
            label = f"{layout}_{'dec_' if dec else ''}{'split' if split else 'interleaved'}"
            tr = channels.rgb_transform(xr, *args)
            moved, ops = 2 * stride * RGB_PIXELS, (2 * RGB_PIXELS // 4 if dec else 0)
            timed[f"dlt_rgb_transform/{label}"] = dict(
                ms=event_ms(lambda: channels.rgb_transform(xr, *args), 20),
                plain_ms=event_ms(lambda: channels.rgb_transform_plain(xr, *args), 5),
                bytes=moved, ops=ops)
            timed[f"dlt_rgb_untransform/{label}"] = dict(
                ms=event_ms(lambda: channels.rgb_untransform(tr, *args), 20),
                plain_ms=event_ms(lambda: channels.rgb_untransform_plain(tr, *args), 5),
                bytes=moved, ops=ops)
            if not dec:
                timed[f"dlt_rgb_transform/{label}"]["library_ms"] = event_ms(
                    lambda: xr.view(RGB_PIXELS, stride).t().contiguous(), 20)
                timed[f"dlt_rgb_untransform/{label}"]["library_ms"] = event_ms(
                    lambda: tr.view(stride, RGB_PIXELS).t().contiguous(), 20)
        _, rows = rgb.candidate_rows(xr, layout, LtuEstimation(), RGB_FAST_CANDIDATES)
        rows = torch.stack(list(rows.values()))
        timed[f"dlt_ltu_counts/{layout}"] = time_counts(rows, rows.shape[1])
    for entry in timed.values():
        bytes_ms = entry["bytes"] / rate * 1e3
        ops_ms = entry["ops"] / int_rate * 1e3
        entry["bound_ms"] = max(bytes_ms, ops_ms)
        entry["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"

    tmp.cleanup()
    emit("times", t0, kernels=timed, host=copies,
         note="kernel ms: CUDA-event medians with L2 flushed before each launch; "
              "host s: medians of 5", run_seconds=time.perf_counter() - run_start)

    # ---- 6. the contract lines ----------------------------------------------------------
    # the row of each kernel: its COMPREHENSIVE shape where it has one, the count
    # kernel on the BC1 COMPREHENSIVE colour rows, as in earlier runs, the mode-sort
    # kernels in the BC7 file's shipped setting, sort and planes, and the RGB kernels
    # in the RGBA8888 file's shipped setting, split only
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = (timed.get(name) or timed.get(f"{name}/bc7_sort_planes")
                 or timed.get(f"{name}/rgba8888_split")
                 or timed[f"{name}/comprehensive"])
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": entry["ms"], "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
            "library_ms": entry.get("library_ms")})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
