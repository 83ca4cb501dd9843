#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dxt_lossless_transform_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as a JSON line with its wall time:

1. device: the card as ``nvidia-smi`` names it, its power limit, the PyTorch build,
   and the zstd library that the BC7/BC6H identity guard loads (its path and
   ``ZSTD_versionNumber()``);
2. build: the one ``nvcc`` call that builds the twenty-one kernel entry points from
   the seven sources ``csrc/bc1_kernels.cu``, ``bc2_kernels.cu``, ``bc3_kernels.cu``,
   ``bc45_kernels.cu``, ``bc7_kernels.cu``, ``rgb_kernels.cu`` and
   ``words_kernels.cu`` into one library under ``build/cuda/`` (skipped when that
   library is already built);
3. check: each kernel against its plain PyTorch version, both on the card, byte for
   byte and for scores as exact integers: every setting (8 for BC1 and BC2, 16 for
   BC3, 2 for BC4 and BC5), n in {1, 3, 2048, 1,398,103} blocks, the FAST and
   COMPREHENSIVE candidate sets; the count (the default-ladder kernel) also on the
   generic kernel's ladders (offsets beyond its 4096-byte halo, a 40-offset ladder,
   the default ladder without offset 3 and its first five offsets) and on 70,000 rows (more than a launch's
   grid.y holds); inputs shorter than one block through every auto-search; the
   BC7/BC6H mode-sort kernels for all 4 settings of both formats, n in {1, 2, 3,
   4095, 4096, 4097, 1,398,103}, on realistic BC7 blocks and on random blocks with
   some byte 0 forced to 0, and on chunks that stress the counting sort (one id
   throughout, every id in turn, ids descending, one chunk per id) at n in {4095,
   4096, 4097, 8191, 8193, 1,398,103} and at one chunk per id with a one-block
   ragged last chunk, each through the round trip, the transform also into rows at
   byte offsets 0-15 of a larger tensor; the identity guard's two outcomes on a
   small input; empty and unaligned input through both mode-sort auto-searches; the RGB channel
   kernels for the three non-identity settings of RGBA8888, BGRA8888 and BGR888,
   both directions, n in {1, 2, 3, 4, 5, 4095, 4096, 4097, 16,777,216} pixels, with
   input and output rows at byte offsets 1-3 into larger tensors, and the count
   kernel on their candidate rows at odd n; empty, unaligned and shorter-than-a-pixel
   input through the RGB auto-search; the word deinterleave for k in {2, 4} and N in
   {1, 2, 3, 4095, 4096, 4097, 1,398,103, 2,097,152} (the largest batch's), byte for
   byte; the per-row count kernel on rows whose lengths run from 0 to the row's
   (0-3 and odd ones included) with the default, far, 40-offset,
   default-without-3 and five-offset ladders, on
   70,000 rows at their own lengths, and against the scalar kernel where every row
   has one length; the windowed count kernel on the rows each BC1 corpus batch
   scores cut into 1, 2 and 8 shards with their 32,768-byte halos (chunks of 1 KiB to
   2 MiB), with the default ladder, one reaching 32,768, 40 offsets, the default
   without 3 and its first five offsets, each shard
   against the plain version and the shards' sum against the per-row kernel on the
   uncut rows; and, on each mesh of the mesh phase, every kernel call its paths make
   (the windowed count, deinterleave and region kernels on each position's shard of
   every BC1-BC5 batch, LTU and host-scored, and of the 4096x4096 BC1 and BC3
   payloads on (1, 8); the untransform kernels on each position's streams in
   ``untransform_step``; the mode-sort kernel on each file's part of a position in
   ``modesort_transform_step``), each against its plain version on the same inputs,
   with each windowed launch's blocks beside the blocks the card holds at once;
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
5. batch: the corpus batch pipeline through its processors, the slice's main path:
   for each of BC1-BC5 32 payloads (the full mip chains of 256², 512², 1024², 2048²,
   1000x600, 300x200, 2048x1024 and 4x4 in turn, the last one empty; ragged files in
   every bucket, one below 2048 blocks, the 2048² ones at 349,527 blocks) through
   ``BatchProcessor(fmt, max_batch=16)`` under LTU, BC1 and BC3 also host-scored with
   ``ZstdEstimation(1)``; 12 BC7 and 12 BC6H payloads up to the 2048² chain and an
   empty one through ``ModeSortBatchProcessor``; 4 payloads of each RGB layout up to
   1024x1024 and an empty one through ``RgbBatchProcessor`` under LTU; every output
   back through ``UntransformBatchProcessor``. Every file must come back, each result
   must equal the port's per-file auto-search on the same payload and estimator, and
   the picks and the sha256 over each format's outputs must equal the JAX package's
   (constants below; the zstd-dependent ones are printed beside theirs). Each path
   (a format's batch run and its load path) has its counts set to 0 just before and
   read just after: one launch of the deinterleave, region, per-row count and
   untransform kernels per batch, not one per file;
6. mesh: the batch corpus again, sharded over three meshes of the one card:
   ``make_mesh()`` (1, 1), and the card listed 8 times (1, 8) and 6 times (3, 2):
   BC1-BC5 through ``BatchProcessor(fmt, mesh=..., max_batch=16)`` under LTU, BC1
   and BC3 also host-scored with ``ZstdEstimation(1)``, every output back through
   ``untransform_step``; the BC7 corpus through ``modesort_transform_step`` and back;
   and the 4096x4096 BC1 and BC3 payloads as batches of one on (1, 8). Every result
   must equal the batch phase's (or, for the 4096x4096 payloads, the per-file
   search's; for BC7, each file's sort+planes transform on one device), every file
   must come back, and the LTU mesh paths must launch the windowed count kernel and
   not the per-row one;
7. cli: the port's CLI, ``main([...])`` in this process on the card, over a texture
   tree written to a temporary directory (about 190 files, 260 MB, the size of a
   game's texture folder): each non-empty payload of the batch corpus as its DDS
   file (31 each of BC1-BC5 under legacy headers, 12 each of BC7 and BC6H under DX10
   headers, 4 of each RGB layout), the main phase's 4096x4096 BC1 and BC7 files
   (above the batch limits of the zstd presets and of the mode sort: they take the
   per-file route there) and one ``junk.txt``. ``transform`` under ``low``,
   ``medium``, ``optimal`` and ``max``, each with ``--batch`` and ``--no-batch``, at
   the default ``--threads``; ``medium`` again at ``--threads 1``, both ways;
   ``untransform`` of each output tree with ``--batch`` and ``--no-batch``, the
   ``optimal`` batched tree with a truncated transformed file added; and a
   ``--profile`` transform of the RGBA8888 files. Every DDS file must come back; the
   only failures must be ``junk.txt`` (exit code 1) and the truncated file; every
   file the batch carries must equal the header, the bytes before the payload, the
   result of the preset's processor on its payload (under ``medium`` the batch
   phase's result) and the bytes after; ``--batch`` must equal ``--no-batch`` but
   where the batch step and the per-file search rank differently (under ``medium``
   exactly the BC5 payloads of ``per_file_differs``), and there the ``--no-batch``
   file must equal the per-file search's; ``--threads 1`` must equal the default;
   the sha256 of the ``low`` and ``medium`` trees must equal the JAX CLI's (for
   ``medium`` from the exact scores; ``optimal`` and ``max`` depend on the zstd
   library and are printed beside theirs); no batch may fall back to per-file; the
   batched ``medium`` transform and its load path must launch the deinterleave,
   region, per-row count and untransform kernels once per batch, and fewer times
   than there are files; the profiler's trace must name one of the port's kernels.
   Each run's launches, wall time, files/s and MB/s are printed;
8. normalize: the normalize-then-auto search (Path A): a
   4096x4096 BC1, BC2 and BC3 file each (the main phase's, seed 7, with
   :func:`normalizable`'s solid, transparent and uniform-alpha blocks mixed in), decoded
   on the card by ``ops/decode`` and held to the numpy decoder; every normalization mode
   (3 for BC1 and BC2, the 4 x 3 grid for BC3) normalized on the card and held to the
   JAX oracle's sha256 and changed-block count (not 0 but for NONE), to the original's
   pixels and to the CPU on the first 65,536 blocks; each mode's auto-search on the
   normalized payload where it lies, its pick and the exact cross-mode score of the
   regions ``_scored_auto`` reads held to the reference's; then
   ``transform_bcN_auto_with_normalization`` under LTU, FAST and COMPREHENSIVE, its
   pick and the sha256 of its output held to the reference's, and the output embedded
   with ``TransformHeader.for_bcN(settings)`` and restored through ``DdsHandler`` to
   the normalized file. The region, count, transform and untransform kernels on the
   picks' payloads are held to their plain versions; decode and normalize times
   (CUDA-event medians), each search's wall and seconds per mode are printed; each
   format's counts are set to 0 just before and read just after;
9. endian: the endian harness (Path B) on the card at 4096 blocks: every format and
   setting through the port's own transforms and untransforms on the native and the
   simulated big-endian host, both ways, the header on both hosts, three synthetic
   containers through ``DdsHandler`` and the batch leg through the BC1-BC5 processors;
   then ``debug-endian``, ``debug-endian-transform`` and ``debug-endian-untransform``
   in this process over synthetic ``r2-256-bc{1,2,3,7}.dds`` files, each exiting 0;
   every transform and untransform kernel must have run under it;
10. times: CUDA-event medians of each kernel at the main path's shapes (the L2 flushed
   by reading 64 MiB before each launch) beside its
   plain version and its bound (the mode-sort kernels in every setting, with the
   ``.t().contiguous()`` call that computes the planes-only layout; the RGB kernels
   in every setting of each layout, with the same call for the split-only layout;
   the count kernel on each RGB file's four candidate rows), and the wall time of
   one transform and one untransform of each file, with the host<->device copies,
   the search, the identity guard's zstd time and the RGB files' reads and writes
   shown apart; the word deinterleave at the largest batch's N beside its plain
   version and ``.t().contiguous()``, the per-row count kernel on the BC1 batch's
   rows (and the windowed one on them cut into 8 shards: the sum of its 8 launches'
   medians), the count, transform and untransform launches' grids and the blocks the
   card holds at once, and each format's batch and
   batched load path against a loop of the per-file entry points, in files/s and
   MB/s, with host assembly, H2D, kernels, D2H and serialization apart; each mesh's
   batch of each BC1-BC5 corpus beside the single-device batch.

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
    # the per-row form of the same TPU kernel (its valid_rows)
    "dlt_ltu_counts_rows": ("bc1_kernels.cu",
                            "dxt_lossless_transform_tpu/estimate/pallas_ltu.py:302"),
    # the per-shard form, with the count window (the mesh scorer's)
    "dlt_ltu_counts_windowed": ("bc1_kernels.cu",
                                "dxt_lossless_transform_tpu/estimate/pallas_ltu.py:328"),
    "dlt_deinterleave_words": ("words_kernels.cu",
                               "dxt_lossless_transform_tpu/ops/pallas/planes.py:159"),
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
# the rows form of each BC1-BC5 transform, the end of the device-scored batch step ->
# (source, what it replaces: no TPU kernel, the JAX pipeline's host serializer of its
# step's lanes)
ROWS_KERNELS = {
    f"dlt_{fmt}_transform_rows": (f"{'bc45' if fmt in ('bc4', 'bc5') else fmt}_kernels.cu",
                                  f"dxt_lossless_transform_tpu/parallel/pipeline.py:{line} "
                                  f"_serialize_{fmt}")
    for fmt, line in (("bc1", 68), ("bc2", 75), ("bc3", 85), ("bc4", 113), ("bc5", 118))}
# the kernels of each format's path: its shuffles, its region kernel if it has one,
# and the count kernel that scores every auto-search; BC6H shares BC7's kernels
PATH_KERNELS = {fmt: [name for name in KERNELS if name.startswith(f"dlt_{fmt.lower()}_")]
                + ["dlt_ltu_counts"] for fmt in FORMATS + ("BC7",)}
PATH_KERNELS["BC6H"] = PATH_KERNELS["BC7"]
RGB_KERNELS = ("dlt_rgb_transform", "dlt_rgb_untransform", "dlt_ltu_counts")
# The batch corpus (scripts/torch_port_reference.py corpus(), seed 7): full mip
# chains of these sizes in turn, 31 payloads and an empty one for each of BC1-BC5;
# the first six twice and an empty one for BC7 and BC6H; these four sizes and an
# empty one for each RGB layout
CORPUS_SIZES = ((256, 256), (512, 512), (1024, 1024), (2048, 2048), (1000, 600),
                (300, 200), (2048, 1024), (4, 4))
BATCH_MODE_SORT_SIZES = CORPUS_SIZES[:6] * 2
BATCH_RGB_SIZES = ((128, 128), (256, 256), (640, 480), (1024, 1024))
BATCH_FORMATS = ("bc1", "bc2", "bc3", "bc4", "bc5")
BATCH_HOST_SCORED = ("bc1", "bc3")
BATCH_MAX = 16
# The picks (candidate indices: BatchProcessor's FAST candidates, BC4/BC5 split
# true then false, BC7/BC6H identity, sort, planes, sort+planes, RGB identity,
# decorrelate, split, both) under the JAX batch pipeline's scoring from the exact
# twin, and the sha256 over each format's concatenated outputs:
#     JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --formats BATCH
# The mode-sort formats' shipped outputs and the host-scored picks go through
# zstd-1 and depend on the library's version; their constants are printed beside
# the run's, which is held to the per-file search on the card instead.
BATCH_REFERENCE = {
    "bc1": {
        "picks": [3, 3, 3, 3, 3, 3, 3, 2, 3, 3, 3, 3, 3, 3, 3, 0, 3, 3, 3, 3, 3, 3, 3,
                  2, 3, 3, 3, 3, 3, 3, 3, 3],
        "sha256": "903a5fe66d8a238e9a5038860b7eca6d0ee1335300364549849d74567f1fc98f",
        "host_sha256": "1d652988daec49ea062139da68c9a03fe3272d562ae9c828c2410bb9aee8a59f"},
    "bc2": {
        "picks": [3, 3, 3, 3, 3, 3, 3, 2, 3, 3, 3, 3, 3, 3, 3, 0, 3, 3, 3, 3, 3, 3, 3,
                  2, 3, 3, 3, 3, 3, 3, 3, 3],
        "sha256": "7a45336fdd3675a6b60b9ba8a7acbc592510c09c591743feca45008a7d65a437"},
    "bc3": {
        "picks": [1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1,
                  0, 1, 1, 1, 1, 1, 1, 1, 7],
        "sha256": "94ce5cccb545fc9b96a51992357009fd6154080324d146940cecd9e0c7afa387",
        "host_sha256": "3e91177087bffef796f936fa6fa1839e34c6b64e623e0cc018531ffcf1487862"},
    "bc4": {
        "picks": [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0,
                  0, 0, 0, 1, 1, 1, 0, 1, 1],
        "sha256": "7ad2b1294a425e5e93c1cdca4e676af65848ea1383c6e347b59d09b236f32e71"},
    "bc5": {
        "picks": [0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1,
                  0, 0, 0, 0, 0, 0, 0, 1, 1],
        "per_file_differs": [3, 6, 9, 11, 17, 25, 30],
        "sha256": "ef51cdd752377b9190b7bf617c8f53738214caeeab04efe417de76d6e83d5363"},
    "bc7": {
        "picks": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3],
        "shipped": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3],
        "sha256": "589bc8371041b0be1a0babd43776ed728dcff9876ec0a16979d69fc2c856cbd0"},
    "bc6h": {
        "picks": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3],
        "shipped": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3],
        "sha256": "80911cf81d91a2c18d82a06c5ea44f2c225b19e248ef7c021eb447612d5d72f3"},
    "rgba8888": {
        "picks": [3, 3, 2, 2, 3],
        "sha256": "af8e3ccdb2d3505337a3b9bd228fc83535ef0a08b7ab3356b37cf6f4a28807f3"},
    "bgra8888": {
        "picks": [3, 3, 2, 2, 3],
        "sha256": "af8e3ccdb2d3505337a3b9bd228fc83535ef0a08b7ab3356b37cf6f4a28807f3"},
    "bgr888": {
        "picks": [3, 3, 2, 2, 3],
        "sha256": "066aad1d0e077b3fcd9226afc002e34ae20afa52cdf0efd856c2f5edefdc9718"},
}
# The cli phase's tree (cli_tree): each non-empty payload of the batch corpus as its
# DDS file, the 4096x4096 BC1 and BC7 files of the main phase and one junk.txt; the
# sha256 of the input tree, of the JAX CLI's low tree, of the medium tree with every
# pick from the exact twin (the JAX CLI's own medium tree and the files where it
# differs beside it), and of the JAX CLI's optimal and max trees, which depend on the
# zstd library's version and are printed beside the run's:
#     JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --formats CLI
CLI_REFERENCE = {
    "files": 194, "bytes": 260328042,
    "input_sha256": "53234ddee109fd83f5871e56fc1d86d9618aa57838faa03416674eaaf2d92b14",
    "low": {"jax_sha256": "3924384914aa37e9cd209875aea1035e6dd736f8c4b4487e5b71e78b32d94d36"},
    "medium": {"sha256": "70bac4646ffba699502f622cebb8e4ab0e48590270694e05395cef05da246428",
               "jax_sha256": "70bac4646ffba699502f622cebb8e4ab0e48590270694e05395cef05da246428"},
    "optimal": {"jax_sha256": "ebd4254b5cb0cd879235eba926ea026327a028714657b5c4f94c245d2d6459dc"},
    "max": {"jax_sha256": "c7e755a520f31fb921050cdb72549b7c083cca70d49caec0b379818220863d09"},
}
CLI_PRESETS = ("low", "medium", "optimal", "max")
# The normalize phase's files (make_dds(fmt, 4096, 4096, 13, seed=7) with the blocks of
# normalizable(fmt, payload, 7)): the file's sha256; for each mode ("c" for BC1 and
# BC2, "a,c" for BC3) the sha256 of the payload the JAX oracle normalizes and the
# blocks that change; for FAST and COMPREHENSIVE under LTU, each mode's pick and the
# exact score of the regions _scored_auto reads on its output, the overall pick
# (modes and settings) and the sha256 of its output. The JAX package's own search
# picks the same in all six:
#     JAX_PLATFORMS=cpu python scripts/torch_port_reference.py --formats NORMALIZE
NORMALIZE_REFERENCE = {
    "BC1": {
        "file_sha256": "58cb3c3ab5ff14963a6f39e6ab8164a1210eb35691c3a4f44e1e672515f46eab",
        "normalized": {
            "0": "b04b4a473f6107e3399301f1422fe3f32364e9bb917ab3d8b5b9025cce89d180",
            "1": "c397a23da1faf49c49f88082d9f38975f9671ef4054fdb366cbb926e64658877",
            "2": "26ed5a0ac2cfd62385603ad7ec4c77335e7d3114e36322d6bfc973666146193a",
        },
        "changed_blocks": {"0": 0, "1": 480618, "2": 305811},
        "fast": {
            "modes": [
                {"modes": [0], "pick": [1, False], "cross_score": 131210107},
                {"modes": [1], "pick": [1, True], "cross_score": 128314675},
                {"modes": [2], "pick": [0, False], "cross_score": 130587841},
            ],
            "pick_modes": [1], "pick": [1, True],
            "sha256": "6af98d0767aa94474373165399f926778d329ad13e5b15885acee18d9bd210c4"},
        "comprehensive": {
            "modes": [
                {"modes": [0], "pick": [1, False], "cross_score": 131210107},
                {"modes": [1], "pick": [2, True], "cross_score": 127990728},
                {"modes": [2], "pick": [0, False], "cross_score": 130587841},
            ],
            "pick_modes": [1], "pick": [2, True],
            "sha256": "007759679d8036d2ef89fcf8ed61478d9f6ebaa77e2899e3c3bc18d12d4e7039"},
    },
    "BC2": {
        "file_sha256": "61b2cf5d82eb3ff4bf5c3196d2f792525fec15bda25485402f7d832039db9f9b",
        "normalized": {
            "0": "a653d5ad3315a3bc335068cca449dcad55334087d28a82671433a9c348cf596b",
            "1": "6c85ca4a76f76ab327ef1540ef3fe60cba71c5e76f79b3b5e4a1f44090d1d2f6",
            "2": "ee04a2cf33bf766b7fcafd188cc7432fdaeb8fd47df24e6d4bbf914bf221163d",
        },
        "changed_blocks": {"0": 0, "1": 441832, "2": 267025},
        "fast": {
            "modes": [
                {"modes": [0], "pick": [1, False], "cross_score": 133429254},
                {"modes": [1], "pick": [1, True], "cross_score": 125918170},
                {"modes": [2], "pick": [1, False], "cross_score": 133428526},
            ],
            "pick_modes": [1], "pick": [1, True],
            "sha256": "e629bfc09b30d793825493e6ed3f662531b7446c073f7bc3e93db4c875331826"},
        "comprehensive": {
            "modes": [
                {"modes": [0], "pick": [1, False], "cross_score": 133429254},
                {"modes": [1], "pick": [1, True], "cross_score": 125918170},
                {"modes": [2], "pick": [1, False], "cross_score": 133428526},
            ],
            "pick_modes": [1], "pick": [1, True],
            "sha256": "e629bfc09b30d793825493e6ed3f662531b7446c073f7bc3e93db4c875331826"},
    },
    "BC3": {
        "file_sha256": "7198ae5a0eab43743407da01bea93ce5084e98346032729df10fddcb7c3fa052",
        "normalized": {
            "0,0": "62428f5196dc9f0a9f164530153d7c4179710dcb469c220eb78a5aea5feaec2d",
            "0,1": "59fadaeaea8d781609d501957792e2d59386d19eac2da39dd82886cd648033d7",
            "0,2": "5b7e12d652478699db49a767634b3e15329a93ffa3ad2852e260b776fda2ead7",
            "1,0": "a233687577ab0bd7a2b3f330b02b3f662b49bccc901dea53b536264ad73f2d46",
            "1,1": "4dc2b6af231e433628a2ceafb78c2075cef4d9b4ecfff4233bc533bcd5bf2c9b",
            "1,2": "0687b7dce00aa93078a08703272f3986c4a95285b1d84dbb47c863b90e0ec377",
            "2,0": "d591213e7f7ca052927b5aa4f97a99cec5736fdc086ab7a524d2a715d539bd78",
            "2,1": "714c4aca670b374ba08e443a4c693bf97ee018c5d82e3ec0594530f5c80f809a",
            "2,2": "123431f08909662488b1c0772cb182295d33b3236f1364bfb4a4826f4e77853b",
            "3,0": "464b1efbe5635fb75f6dcd5a1308ac50ace0994b9991eaec18dfe7dd6b40a758",
            "3,1": "98c88fa2eda3034bb00e16a7d38a023f830411d1e19dc46236fedde71fd15ea2",
            "3,2": "7062d61ba30c54a758c8d4d769c8ee0961e5e77891dd1fe142103258361b3ba6",
        },
        "changed_blocks": {
            "0,0": 0, "0,1": 441832, "0,2": 267025, "1,0": 357960, "1,1": 686522,
            "1,2": 556579, "2,0": 358406, "2,1": 686840, "2,2": 556949, "3,0": 358406,
            "3,1": 686840, "3,2": 556949
        },
        "fast": {
            "modes": [
                {"modes": [0, 0], "pick": [1, True, False], "cross_score": 200704688},
                {"modes": [0, 1], "pick": [1, True, True], "cross_score": 193193604},
                {"modes": [0, 2], "pick": [1, True, False], "cross_score": 200703960},
                {"modes": [1, 0], "pick": [1, True, False], "cross_score": 200655478},
                {"modes": [1, 1], "pick": [1, True, True], "cross_score": 193144394},
                {"modes": [1, 2], "pick": [1, True, False], "cross_score": 200654750},
                {"modes": [2, 0], "pick": [1, False, False], "cross_score": 200641927},
                {"modes": [2, 1], "pick": [1, False, True], "cross_score": 193130843},
                {"modes": [2, 2], "pick": [1, False, False], "cross_score": 200641199},
                {"modes": [3, 0], "pick": [1, False, False], "cross_score": 200595702},
                {"modes": [3, 1], "pick": [1, False, True], "cross_score": 193084618},
                {"modes": [3, 2], "pick": [1, False, False], "cross_score": 200594974},
            ],
            "pick_modes": [3, 1], "pick": [1, False, True],
            "sha256": "bff1ea0e124f2c7293798ab47f22f92d716fe3b8f4ae3393af44a0a09b863453"},
        "comprehensive": {
            "modes": [
                {"modes": [0, 0], "pick": [1, True, False], "cross_score": 200704688},
                {"modes": [0, 1], "pick": [1, True, True], "cross_score": 193193604},
                {"modes": [0, 2], "pick": [1, True, False], "cross_score": 200703960},
                {"modes": [1, 0], "pick": [1, True, False], "cross_score": 200655478},
                {"modes": [1, 1], "pick": [1, True, True], "cross_score": 193144394},
                {"modes": [1, 2], "pick": [1, True, False], "cross_score": 200654750},
                {"modes": [2, 0], "pick": [1, False, False], "cross_score": 200641927},
                {"modes": [2, 1], "pick": [1, False, True], "cross_score": 193130843},
                {"modes": [2, 2], "pick": [1, False, False], "cross_score": 200641199},
                {"modes": [3, 0], "pick": [1, False, False], "cross_score": 200595702},
                {"modes": [3, 1], "pick": [1, False, True], "cross_score": 193084618},
                {"modes": [3, 2], "pick": [1, False, False], "cross_score": 200594974},
            ],
            "pick_modes": [3, 1], "pick": [1, False, True],
            "sha256": "bff1ea0e124f2c7293798ab47f22f92d716fe3b8f4ae3393af44a0a09b863453"},
    },
}
# N words per stream in the deinterleave check: the largest batch is the four
# 2048x2048 chains in the 524,288-block bucket, 2,097,152 blocks
LARGEST_BATCH_N = 4 * 524_288
WORD_SIZES = (1, 2, 3, 4095, 4096, 4097, BLOCKS, LARGEST_BATCH_N)
# the mode-sort kernels' block counts in the check phase, and those of the chunks
# that stress the transform's counting sort (testgen.mode_sort_edges; each format's
# one chunk per id with a one-block ragged last chunk besides), the transform also
# written into rows at every byte offset into a larger tensor
MODE_SORT_SIZES = (1, 2, 3, 4095, 4096, 4097, BLOCKS)
MODE_SORT_EDGE_SIZES = (4095, 4096, 4097, 8191, 8193, BLOCKS)
MODE_SORT_OFFSETS = range(16)
# rows for the count kernel's many-rows case: more than one launch's grid.y (65,535)
MANY_ROWS = 70_000
# The generic count kernel (every ladder but the whole default one): offsets beyond
# its 4096-byte halo in shared memory, a 40-offset ladder, and two ladders within the
# halo (the default without offset 3, and the default's first five offsets, which
# the default kernel, counting all twenty, would miscount on rows past 4,100 bytes).
FAR_OFFSETS = (1, 2, 4096, 4097, 8192, 65536)
LADDER_40 = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 20, 24, 28, 32,
             40, 48, 64, 80, 96, 128, 160, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
             4096, 6144, 12288, 24576, 49152)
# The windowed count kernel's ladders: its offsets reach at most its 32,768-byte halo
# (SPAN): the far ladder with offsets beyond the 4096 bytes in shared memory up to
# SPAN, and LADDER_40 with SPAN in place of 49,152. The shard counts it is checked at.
WINDOW_SPAN = 32768
WINDOW_FAR = (1, 2, 4096, 4097, 8192, WINDOW_SPAN)
WINDOW_LADDER_40 = LADDER_40[:-1] + (WINDOW_SPAN,)
WINDOW_SHARDS = (1, 2, 8)
# The mesh phase's meshes: the one card, and the card listed 8 and 6 times
MESH_SHAPES = {"1x1": {"files": 1, "blocks": 1}, "1x8": {"files": 1, "blocks": 8},
               "3x2": {"files": 3, "blocks": 2}}
# Peak rates for the bounds. Device memory bytes/s by card, from NVIDIA's data
# sheets. Integer operations/s: a Hopper SM issues 32-bit integer work to 64 INT32
# lanes (16 in each of its 4 partitions, NVIDIA's H100 architecture whitepaper),
# so the rate is SMs x 64 x the card's maximum SM clock, read from the card.
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100": 3.35e12, "H200": 4.8e12}
INT32_LANES_PER_SM = 64
# Integer operations per item that the functions need, estimated from the
# arithmetic in csrc/bc1_kernels.cu: 27 per YCoCg pair (shifts, masks, adds,
# subtractions, packing). The count, from the function and not from any kernel: a
# position needs at least its gram and the add of its weight, and each gram compare
# that the data needs (up to the nearest match) a compare and the select of its
# weight, so 2 per position and 2 per compare.
OPS_PAIR = 27
OPS_GRAM, OPS_COMPARE = 2, 2
# and, from csrc/bc7_kernels.cu, 24 per block to find its mode id, rank it (match,
# two population counts, table reads and adds) and pack its nibble, when sorting
OPS_MODE_SORT = 24
# Instructions the compiled default-ladder count kernel issues (python3
# scripts/sass_ops.py --dump, ltu_default_kernel<false, false> on sm_90a): on the
# path of its main loop without the stream-head guard, 252 in the four groups, the
# 80 compares of a thread's four positions with their votes and merges, and 32 per
# pass of four positions besides (the end marks, the window's words, the sum). They
# give the count kernel's issue time, which the times phase prints beside its bound.
SASS_PER_COMPARE, SASS_PER_POSITION = 252 / 80, 32 / 4


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


def batch_corpus(fmt: str) -> list:
    """The batch phase's payloads of ``fmt`` (``bc1``-``bc5``, ``bc7``, ``bc6h`` or an
    RGB layout), as ``scripts/torch_port_reference.py:corpus`` makes them with the
    JAX package's generators."""
    from dxt_lossless_transform_tpu_torch.utils.testgen import (
        bc1_realistic, bc2_realistic, bc3_realistic, bc7_realistic, bc_blocks,
        chain_blocks, make_uncompressed_dds,
    )

    if fmt in BATCH_FORMATS:
        gen = {"bc1": bc1_realistic, "bc2": bc2_realistic, "bc3": bc3_realistic}.get(fmt)
        size = BLOCK_SIZE[fmt.upper()]
        out = []
        for i in range(31):
            n = chain_blocks(*CORPUS_SIZES[i % len(CORPUS_SIZES)])
            out.append(gen(n, SEED + i) if gen else bc_blocks(n, size, SEED + i))
        return out + [b""]
    if fmt in ("bc7", "bc6h"):
        return [bc7_realistic(chain_blocks(*size), SEED + i + (100 if fmt == "bc6h" else 0))
                for i, size in enumerate(BATCH_MODE_SORT_SIZES)] + [b""]
    return [make_uncompressed_dds(fmt, w, h, seed=SEED + i)[0x80:]
            for i, (w, h) in enumerate(BATCH_RGB_SIZES)] + [b""]


def normalizable(fmt: str, payload: bytes, seed: int) -> bytes:
    """``payload`` (BC1, BC2 or BC3 blocks) with the blocks that normalization
    rewrites mixed in, after the JAX package's recipe (``tests/test_normalize.py``
    ``_mixed_bc1``): about a quarter solid colour with indices 0 (half of them with
    c0 == c1, as that recipe writes them, half with another c1, which
    ``REPLICATE_COLOR`` rewrites too); for BC1 about an eighth fully transparent; for
    BC3 about a quarter with uniform alpha (a0 = v, another a1, indices 0), a third of
    those opaque. The normalize phase's data, the reference script's and the tests'."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cols = 2 if fmt == "BC1" else 4
    words = np.frombuffer(payload, "<u4").reshape(-1, cols).copy()
    n, colour = len(words), cols - 2
    solid = rng.random(n) < 0.25
    c0 = rng.integers(0, 65536, n, np.uint32)
    c1 = np.where(rng.random(n) < 0.5, c0, rng.integers(0, 65536, n, np.uint32))
    words[solid, colour] = (c0 | (c1 << 16))[solid]
    words[solid, colour + 1] = 0
    if fmt == "BC1":
        transparent = (rng.random(n) < 0.125) & ~solid
        words[transparent, 0] = 0x12340000  # c0 = 0 <= c1: three colours, index 3
        words[transparent, 1] = 0xFFFFFFFF
    if fmt == "BC3":
        uniform = rng.random(n) < 0.25
        value = np.where(rng.random(n) < 1 / 3, 255,
                         rng.integers(0, 256, n)).astype(np.uint32)
        a1 = rng.integers(0, 256, n, np.uint32)
        words[uniform, 0] = (value | (a1 << 8))[uniform]
        words[uniform, 1] = 0
    return words.tobytes()


NORMALIZE_FORMATS = ("BC1", "BC2", "BC3")
# the blocks the normalize phase runs on the CPU beside the card
NORMALIZE_CPU_BLOCKS = 65_536
# the kernels of each normalize path: the region, count and transform kernels of its
# searches and the untransform of its load path
NORMALIZE_KERNELS = {fmt: [f"dlt_{fmt.lower()}_regions", "dlt_ltu_counts",
                           f"dlt_{fmt.lower()}_transform", f"dlt_{fmt.lower()}_untransform"]
                     for fmt in NORMALIZE_FORMATS}
# the kernels that the endian harness must launch under the simulation: every
# transform and untransform, and on its batch leg the deinterleave, the region
# kernels and the per-row count
ENDIAN_KERNELS = ("dlt_bc1_transform", "dlt_bc1_untransform", "dlt_bc2_transform",
                  "dlt_bc2_untransform", "dlt_bc3_transform", "dlt_bc3_untransform",
                  "dlt_bc4_transform", "dlt_bc4_untransform", "dlt_bc5_transform",
                  "dlt_bc5_untransform", "dlt_bc7_transform", "dlt_bc7_untransform",
                  "dlt_rgb_transform", "dlt_rgb_untransform", "dlt_deinterleave_words",
                  "dlt_bc1_regions", "dlt_bc2_regions", "dlt_bc3_regions",
                  "dlt_ltu_counts_rows")


def normalize_phase(dev, path_launches: dict, compare, compare_counts) -> dict:
    """The normalize phase (Path A): for each of BC1, BC2 and BC3, the 4096x4096 file
    with :func:`normalizable`'s blocks, decoded on the card and held to the numpy
    decoder; each mode normalized on the card and held to the reference's sha256 and
    changed blocks, to the original's pixels and to the CPU on the first
    :data:`NORMALIZE_CPU_BLOCKS` blocks; each mode's search (the auto-search on the
    normalized payload where it lies and the exact score of the regions
    ``_scored_auto`` reads) held to the reference's pick and cross-mode score; then the
    public ``transform_bcN_auto_with_normalization`` under LTU, FAST and
    COMPREHENSIVE, held to the reference's pick and sha256, its output embedded with
    its header and restored through ``DdsHandler`` to the normalized file. The
    region, transform, untransform and count kernels on the picks' payloads are held
    to their plain versions. Each drive of the public entry point (one per format
    under FAST and one under COMPREHENSIVE: the search and the restore of its output)
    has its counts set to 0 just before and read just after; the checks' own decodes,
    searches and scores run outside that window. Returns the phase's results."""
    import numpy as np
    import torch
    from dxt_lossless_transform_tpu_torch import backend
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
    from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
    from dxt_lossless_transform_tpu_torch.ops import auto, decode, normalize
    from dxt_lossless_transform_tpu_torch.ops.cuda import regions, shuffle
    from dxt_lossless_transform_tpu_torch.oracle import decode as odecode
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
        BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import make_dds

    sync = torch.cuda.synchronize
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)
    candidates = {"BC1": (BC1_FAST_CANDIDATES, BC1_COMPREHENSIVE_CANDIDATES),
                  "BC2": (BC2_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES),
                  "BC3": (BC3_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES)}
    handler = DdsHandler(dev)
    est = LtuEstimation()
    results = {}

    def key(settings) -> list:
        return ([int(settings.decorrelation_mode)]
                + ([settings.split_alpha_endpoints]
                   if hasattr(settings, "split_alpha_endpoints") else [])
                + [settings.split_colour_endpoints])

    def cross_score(fmt: str, out: torch.Tensor) -> int:
        """The exact score of the regions ``_scored_auto`` reads on ``out``."""
        n = out.numel()
        parts = ([out[: n // 8], out[n // 2: 3 * n // 4]] if fmt == "BC3" else
                 [out[n // 2: n // 2 + n // 4]] if fmt == "BC2" else [out[: n // 2]])
        return sum(int(est.estimate_batch_device(r.reshape(1, -1), r.numel())[0])
                   for r in parts)

    def seconds(fn):
        sync()
        t = time.perf_counter()
        value = fn()
        sync()
        return value, time.perf_counter() - t

    for fmt in NORMALIZE_FORMATS:
        ref = NORMALIZE_REFERENCE[fmt]
        lower, bs = fmt.lower(), 8 if fmt == "BC1" else 16
        cols = bs // 4
        base = make_dds(fmt, SIZE, SIZE, MIPS, seed=SEED)
        payload = normalizable(fmt, base[0x80:], SEED)
        dds = base[:0x80] + payload
        if hashlib.sha256(dds).hexdigest() != ref["file_sha256"]:
            fail(f"normalize {fmt}: the mixed file differs from the reference run's")
        entry = {"blocks": len(payload) // bs, "modes": {}}
        x = backend.upload(payload, dev)
        words = decode.words(x, cols)
        decoder = getattr(decode, f"decode_{lower}")
        planes = decoder(words)
        host_pixels = getattr(odecode, f"decode_{lower}")(payload)
        if not np.array_equal(np.moveaxis(planes.cpu().numpy(), 0, -1).reshape(
                -1, 4, 4, 4), host_pixels):
            fail(f"normalize {fmt}: the card's decode differs from the numpy decoder")
        entry["decode_ms"] = kernel_ms(lambda: decoder(words), 5, flush)
        grid = ([(a, c) for a in normalize.AM.all_values() for c in normalize.CM.all_values()]
                if fmt == "BC3" else [(c,) for c in normalize.CM.all_values()])
        normalize_words = getattr(normalize, f"normalize_words_{lower}")
        normalized = {}
        cpu_n = NORMALIZE_CPU_BLOCKS * bs
        for modes in grid:
            label = ",".join(str(int(m)) for m in modes)
            w = normalize_words(words, *modes)
            data = backend.download(w.reshape(-1).view(torch.uint8))
            normalized[modes] = w
            changed = int((w != words).any(dim=1).sum())
            if hashlib.sha256(data).hexdigest() != ref["normalized"][label]:
                fail(f"normalize {fmt} {label}: differs from the JAX oracle's")
            if changed != ref["changed_blocks"][label] or (changed == 0) != (
                    all(int(m) == 0 for m in modes)):
                fail(f"normalize {fmt} {label}: {changed} blocks changed")
            if not torch.equal(decoder(w), planes):
                fail(f"normalize {fmt} {label}: the pixels differ from the original's")
            if data[:cpu_n] != getattr(normalize, f"normalize_blocks_{lower}")(
                    payload[:cpu_n], *modes, device="cpu"):
                fail(f"normalize {fmt} {label}: the card and the CPU differ")
            entry["modes"][label] = {
                "changed_blocks": changed,
                "normalize_ms": kernel_ms(lambda: normalize_words(words, *modes), 5, flush)}
        for name, cand in zip(("fast", "comprehensive"), candidates[fmt]):
            want = ref[name]
            per_mode = []
            for modes, mode_ref in zip(grid, want["modes"]):
                if mode_ref["modes"] != [int(m) for m in modes]:
                    fail(f"normalize {fmt}: the reference's modes are in another order")
                nx = normalized[modes].reshape(-1).view(torch.uint8)
                (out, settings), secs = seconds(
                    lambda: auto.transform_auto_tensor(fmt, nx, est, cand))
                score = cross_score(fmt, out)
                if key(settings) != mode_ref["pick"] or score != mode_ref["cross_score"]:
                    fail(f"normalize {fmt} {name} {modes}: pick {key(settings)}, score "
                         f"{score}; the reference {mode_ref['pick']}, "
                         f"{mode_ref['cross_score']}")
                per_mode.append({"modes": [int(m) for m in modes], "pick": key(settings),
                                 "cross_score": score, "search_s": secs})
            api = getattr(normalize, f"transform_{lower}_auto_with_normalization")
            # the main path alone: the search and the restore of its output
            sync()
            backend.reset_launch_counts()
            (out, settings, *modes), wall = seconds(lambda: api(
                payload, est, name == "comprehensive", device=dev))
            header = getattr(TransformHeader, f"for_{lower}")(settings)
            (back, restore_s) = seconds(lambda: handler.untransform(
                header.to_bytes() + dds[4:0x80] + out))
            counts = {k: v for k, v in backend.LAUNCHES.items() if v}
            path_launches[f"normalize/{fmt}/{name}"] = counts
            if any(counts.get(k, 0) == 0 for k in NORMALIZE_KERNELS[fmt]):
                fail(f"a kernel of the normalize {fmt} {name} path was not launched on "
                     f"it: {counts}")
            if (key(settings), [int(m) for m in modes]) != (want["pick"],
                                                             want["pick_modes"]):
                fail(f"normalize {fmt} {name}: picks {key(settings)} {modes}, the "
                     f"reference {want['pick']} {want['pick_modes']}")
            if hashlib.sha256(out).hexdigest() != want["sha256"]:
                fail(f"normalize {fmt} {name}: the output differs from the reference's")
            if back != dds[:0x80] + backend.download(
                    normalized[tuple(modes)].reshape(-1).view(torch.uint8)):
                fail(f"normalize {fmt} {name}: the load path did not give the normalized "
                     f"file")
            entry[name] = {"settings": str(settings), "modes": [int(m) for m in modes],
                           "wall_s": wall, "s_per_mode": wall / len(grid),
                           "restore_s": restore_s, "per_mode": per_mode}
        # the kernels on the COMPREHENSIVE pick's payload against their plain versions
        nx = normalized[tuple(ref["comprehensive"]["pick_modes"])].reshape(-1).view(
            torch.uint8)
        n = nx.numel() // bs
        ckeys = auto.colour_keys(candidates[fmt][1])[0]
        if fmt == "BC3":
            akeys = (False, True)
            alpha, colour = regions.bc3_regions(nx, akeys, ckeys)
            want_alpha, want_colour = regions.bc3_regions_plain(nx, akeys, ckeys)
            compare("dlt_bc3_regions", alpha, want_alpha, "normalize alpha rows")
            compare("dlt_bc3_regions", colour, want_colour, "normalize colour rows")
            compare_counts(alpha, 2 * n, "normalize BC3 alpha rows")
            rows = colour
        else:
            rows = getattr(regions, f"{lower}_regions")(nx, ckeys)
            compare(f"dlt_{lower}_regions", rows,
                    getattr(regions, f"{lower}_regions_plain")(nx, ckeys),
                    f"normalize {fmt} rows")
        compare_counts(rows, 4 * n, f"normalize {fmt} colour rows")
        args = ((1, True, True) if fmt == "BC3" else (1, True))
        t = getattr(shuffle, f"{lower}_transform")(nx, *args)
        compare(f"dlt_{lower}_transform", t,
                getattr(shuffle, f"{lower}_transform_plain")(nx, *args), f"normalize {fmt}")
        compare(f"dlt_{lower}_untransform", getattr(shuffle, f"{lower}_untransform")(t, *args),
                getattr(shuffle, f"{lower}_untransform_plain")(t, *args), f"normalize {fmt}")
        del normalized, planes, x, words
        results[fmt] = entry
    return results


def endian_phase(dev, path_launches: dict, tmpdir: Path) -> dict:
    """The endian phase (Path B): the endian harness on the card at 4096 blocks (every
    format and setting through the port's transforms, both hosts, both ways; the
    synthetic containers through ``DdsHandler``; the batch leg), then the three
    ``debug-endian*`` commands in this process over a directory of synthetic
    ``r2-256-bc{1,2,3,7}.dds`` files. Its counts are set to 0 just before and read just
    after. Returns the phase's results."""
    import contextlib
    import io

    import torch
    from dxt_lossless_transform_tpu_torch import backend
    from dxt_lossless_transform_tpu_torch.cli import main as cli_main
    from dxt_lossless_transform_tpu_torch.utils.endian_harness import run_matrix
    from dxt_lossless_transform_tpu_torch.utils.testgen import make_dds, make_dx10_dds

    assets, exchange = tmpdir / "endian_assets", tmpdir / "endian_exchange"
    assets.mkdir()
    for fmt in ("BC1", "BC2", "BC3"):
        (assets / f"r2-256-{fmt.lower()}.dds").write_bytes(
            make_dds(fmt, 256, 256, 9, seed=SEED))
    (assets / "r2-256-bc7.dds").write_bytes(make_dx10_dds("BC7", 256, 256, 9, seed=SEED))
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t = time.perf_counter()
    report = run_matrix(n_blocks=4096, device=dev)
    matrix_s = time.perf_counter() - t
    if len(report.per_format) != 10 or report.containers != 3 or report.batches != 5:
        fail(f"endian: the matrix covered {report}")
    commands = {}
    for label, argv in (
            ("debug-endian", ["debug-endian", "--assets", str(assets)]),
            ("debug-endian-transform", ["debug-endian-transform", "--assets", str(assets),
                                        "--exchange", str(exchange)]),
            ("debug-endian-untransform", ["debug-endian-untransform", "--assets",
                                          str(assets), "--exchange", str(exchange)])):
        out, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main.main(["--device", str(dev), *argv])
        commands[label] = {"rc": rc, "seconds": time.perf_counter() - t,
                           "last_line": out.getvalue().strip().splitlines()[-1:]}
        if rc != 0:
            fail(f"endian: {label} exited {rc}: {err.getvalue()}")
    torch.cuda.synchronize()
    counts = {k: v for k, v in backend.LAUNCHES.items() if v}
    path_launches["endian"] = counts
    if any(counts.get(k, 0) == 0 for k in ENDIAN_KERNELS):
        fail(f"endian: a kernel was not launched under the harness: {counts}")
    return {"checks": report.checks, "per_format": report.per_format,
            "containers": report.containers, "batches": report.batches,
            "matrix_s": matrix_s, "commands": commands}


def kernel_ms(fn, iters: int, flush) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` calls after one untimed, with
    L2 flushed before each by reading ``flush`` (64 MiB on the card), so that the
    cache holds clean lines and the timed kernel writes back none of the flush's (a
    write would leave ~50 MB of dirty lines). The one timing method of every kernel,
    here and in ``scripts/time_kernels.py``."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bc1_batch_rows(corpus_bc1: list, dev) -> tuple:
    """The timed per-row count input: the rows the BC1 batch step scores for the
    four 2048x2048 chains of ``corpus_bc1`` (``batch_corpus("bc1")``) in their
    524,288-block bucket, each candidate key's colour row -> ((R, L) uint8 rows on
    ``dev``, the blocks of one chain)."""
    import torch
    from dxt_lossless_transform_tpu_torch.ops.cuda import regions
    from dxt_lossless_transform_tpu_torch.parallel import sharded
    from dxt_lossless_transform_tpu_torch.utils.testgen import chain_blocks

    big = [d for d in corpus_bc1 if len(d) == 8 * chain_blocks(2048, 2048)]
    bucket = LARGEST_BATCH_N // len(big)
    flats = torch.zeros((len(big), 2 * bucket), dtype=torch.int32)
    for row, d in enumerate(big):
        flats[row, :len(d) // 4] = torch.frombuffer(bytearray(d), dtype=torch.int32)
    n_big = len(big[0]) // 8
    rows = sharded._colour_rows_batched(
        flats.to(dev), [n_big] * len(big), sharded._BC1_CANDIDATES, 2, regions.bc1_regions)
    return rows.view(-1, rows.shape[2]), n_big


def shard_windows(rows, nb: int) -> tuple:
    """The (R, L) rows cut into ``nb`` shards, each shard's window [halo | chunk |
    halo] as the mesh step makes it -> (the windows, the chunk length)."""
    import torch

    lc = rows.shape[1] // nb
    padded = torch.nn.functional.pad(rows, (WINDOW_SPAN, WINDOW_SPAN))
    return [padded[:, s * lc:(s + 1) * lc + 2 * WINDOW_SPAN].contiguous()
            for s in range(nb)], lc


def cli_tree(root: Path, corpus: dict, big: dict) -> dict:
    """Write the cli phase's tree under ``root`` as
    ``scripts/torch_port_reference.py:cli_tree`` does with the JAX package's
    generators: one subdirectory per format, each non-empty payload of ``corpus``
    (BC1-BC5 under legacy headers, BC7 and BC6H under DX10 headers, the RGB layouts as
    their uncompressed files), the files of ``big`` (format -> the main phase's
    4096x4096 file) and ``junk.txt``. Returns relative path -> (format, the payload's
    index in the corpus, None for a file of ``big``)."""
    from dxt_lossless_transform_tpu_torch.utils.testgen import (
        make_dds, make_dx10_dds, make_uncompressed_dds,
    )

    where = {}

    def write(rel: str, data: bytes, fmt: str, index) -> None:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
        where[rel] = (fmt, index)

    for fmt in BATCH_FORMATS:
        for i, payload in enumerate(corpus[fmt]):
            if payload:
                w, h = CORPUS_SIZES[i % len(CORPUS_SIZES)]
                header = make_dds(fmt.upper(), w, h, max(w, h).bit_length(),
                                  realistic=False)[:0x80]
                write(f"{fmt}/{i:02d}_{w}x{h}.dds", header + payload, fmt, i)
    for fmt in ("bc7", "bc6h"):
        for i, payload in enumerate(corpus[fmt]):
            if payload:
                w, h = BATCH_MODE_SORT_SIZES[i]
                write(f"{fmt}/{i:02d}_{w}x{h}.dds", make_dx10_dds(
                    fmt.upper(), w, h, max(w, h).bit_length(), payload=payload), fmt, i)
    for layout in (fmt.lower() for fmt in RGB):
        for i, (w, h) in enumerate(BATCH_RGB_SIZES):
            write(f"{layout}/{i:02d}_{w}x{h}.dds",
                  make_uncompressed_dds(layout, w, h, seed=SEED + i), layout, i)
    for fmt, data in big.items():
        write(f"{fmt}/{SIZE}x{SIZE}.dds", data, fmt, None)
    (root / "junk.txt").write_bytes(b"not a texture\n")
    return where


def tree_files(root: Path) -> dict:
    """Relative path -> bytes of every file under ``root``."""
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


def tree_digest(files: dict) -> str:
    """sha256 over the files of a tree: each one's relative path, a zero byte and its
    bytes, in the order of the sorted paths (``torch_port_reference.py:tree_digest``)."""
    h = hashlib.sha256()
    for rel in sorted(files):
        h.update(rel.encode() + b"\0")
        h.update(files[rel])
    return h.hexdigest()


def cli_phase(dev, corpus: dict, big: dict, batch_out: dict, tmpdir: Path,
              path_launches: dict) -> dict:
    """The cli phase: the port's ``main([...])`` in this process, on the card, over
    the tree of :func:`cli_tree` (the runs and checks are listed in the module
    docstring). Each run's launch counts are set to 0 just before it and kept in
    ``path_launches``. Returns the phase's results."""
    import contextlib
    import io
    import re
    import shutil

    import torch
    from dxt_lossless_transform_tpu_torch import backend
    from dxt_lossless_transform_tpu_torch.cli import main as cli_main
    from dxt_lossless_transform_tpu_torch.formats.bundle import _SLOTS
    from dxt_lossless_transform_tpu_torch.formats.dds import parse_dds
    from dxt_lossless_transform_tpu_torch.formats.handlers import (
        _DDS_TO_TRANSFORM, DdsHandler,
    )
    from dxt_lossless_transform_tpu_torch.parallel import pipeline

    src = tmpdir / "cli_in"
    where = cli_tree(src, corpus, big)
    inputs = tree_files(src)
    n_files, n_bytes = len(inputs), sum(map(len, inputs.values()))
    if tree_digest(inputs) != CLI_REFERENCE["input_sha256"]:
        fail("cli: the tree differs from the reference run's")
    info = {rel: parse_dds(data) for rel, data in inputs.items() if rel in where}
    fmt_of = {rel: _DDS_TO_TRANSFORM[i.format].name.lower() for rel, i in info.items()}
    results = {"files": n_files, "bytes": n_bytes, "runs": {}}
    runs = results["runs"]

    def run(label: str, argv: list, root: Path) -> tuple:
        """One command over the tree at ``root``: its counts set to 0 just before and
        read just after; returns (exit code, the files it reported as failed)."""
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = {name: count for name, count in backend.LAUNCHES.items() if count}
        path_launches[f"cli/{label}"] = counts
        if "falling back to per-file" in err.getvalue():
            fail(f"cli {label}: a batch fell back to per-file: {err.getvalue()}")
        failed = {Path(line[len("error: "):].split(": ")[0]).relative_to(root).as_posix()
                  for line in err.getvalue().splitlines() if line.startswith("error: ")}
        sizes = [p.stat().st_size for p in root.rglob("*") if p.is_file()]
        runs[label] = {"rc": rc, "seconds": seconds, "files": len(sizes),
                       "bytes": sum(sizes), "files_per_s": len(sizes) / seconds,
                       "MB_per_s": sum(sizes) / seconds / 1e6, "launches": counts,
                       "failed": sorted(failed), "stdout": out.getvalue().strip()}
        print(json.dumps({"cli_run": label, **runs[label]}), flush=True)
        return rc, failed

    def transform(label: str, preset: str, *flags) -> dict:
        dst = tmpdir / f"cli_{label}"
        rc, failed = run(label, ["transform", str(src), str(dst), "--preset", preset,
                                 *flags], src)
        outs = tree_files(dst)
        if rc != 1 or failed != {"junk.txt"} or set(outs) != set(info):
            fail(f"cli {label}: exit code {rc}, failed {sorted(failed)}, missing "
                 f"{sorted(set(info) - set(outs))}, extra {sorted(set(outs) - set(info))}")
        return outs

    def untransform(label: str, tree: str, flag: str, broken=()) -> None:
        back, tree = tmpdir / f"cli_{label}", tmpdir / f"cli_{tree}"
        rc, failed = run(label, ["untransform", str(tree), str(back), flag], tree)
        backs = tree_files(back)
        if rc != (1 if broken else 0) or failed != set(broken) \
                or set(backs) != set(info) \
                or any(backs[rel] != inputs[rel] for rel in info):
            fail(f"cli {label}: exit code {rc}, failed {sorted(failed)}, or a file did "
                 f"not come back")
        shutil.rmtree(back)

    def expected_batched(preset: str) -> dict:
        """Relative path -> the file the batch writes for each file it carries: the
        header of its result, the file's bytes 4..start, the result and the bytes
        after the payload; the result from the preset's processor on the same
        payload (under medium, the batch phase's result)."""
        make = cli_main._batch_processors_for_preset(preset, 64, dev)
        groups = {}
        for rel, i in info.items():
            if cli_main._batchable(fmt_of[rel], i.data_length, preset):
                groups.setdefault(fmt_of[rel], []).append(rel)
        want = {}
        for fmt, rels in groups.items():
            payloads = [inputs[rel][info[rel].data_offset:
                                    info[rel].data_offset + info[rel].data_length]
                        for rel in rels]
            if preset == "medium":
                fresh = [p for rel, p in zip(rels, payloads) if where[rel][1] is None]
                fresh = iter(make(fmt).process(fresh) if fresh else [])
                res = [next(fresh) if where[rel][1] is None
                       else batch_out[fmt][where[rel][1]] for rel in rels]
            else:
                res = make(fmt).process(payloads)
            for rel, r in zip(rels, res):
                i, data = info[rel], inputs[rel]
                header = _SLOTS[_DDS_TO_TRANSFORM[i.format]][1](r.settings)
                want[rel] = (header.to_bytes() + data[4:i.data_offset] + r.transformed
                             + data[i.data_offset + i.data_length:])
        return want

    digests = {}
    for preset in CLI_PRESETS:
        recorded = []
        if preset == "medium":  # record the processors the CLI makes
            original = cli_main._batch_processors_for_preset

            def recording(*args, **kwargs):
                make = original(*args, **kwargs)

                def make_recorded(fmt):
                    proc = make(fmt)
                    recorded.append((fmt, proc))
                    return proc
                return make_recorded

            cli_main._batch_processors_for_preset = recording
        try:
            batched = transform(f"{preset}/transform_batch", preset, "--batch")
        finally:
            if preset == "medium":
                cli_main._batch_processors_for_preset = original
        per_file = transform(f"{preset}/transform_no_batch", preset, "--no-batch")
        digests[preset] = tree_digest(batched)
        want = expected_batched(preset) if preset != "low" else {}
        if any(batched[rel] != out for rel, out in want.items()):
            fail(f"cli {preset}: a batched file differs from its processor's result: "
                 f"{[rel for rel, out in want.items() if batched[rel] != out]}")
        differs = sorted(rel for rel in info if batched[rel] != per_file[rel])
        bundle = cli_main.make_preset_bundle(preset)
        handler = DdsHandler(dev)
        if any(per_file[rel] != handler.transform_bundle(inputs[rel], bundle)
               for rel in differs):
            fail(f"cli {preset}: a --no-batch file differs from the per-file search")
        results[preset] = {"batched_files": len(want), "batch_differs": differs,
                           "sha256": digests[preset]}
        if preset == "medium":
            expect = sorted(rel for rel, (fmt, index) in where.items() if fmt == "bc5"
                            and index in BATCH_REFERENCE["bc5"]["per_file_differs"])
            if differs != expect:
                fail(f"cli medium: --batch and --no-batch differ on {differs}, "
                     f"expected {expect}")
            # launches once per batch, not once per file
            counts = path_launches["cli/medium/transform_batch"]
            batches = {}
            for fmt, proc in recorded:
                batches[fmt] = batches.get(fmt, 0) + proc.batches
            want_counts = {"dlt_deinterleave_words": sum(batches.get(f, 0)
                                                         for f in ("bc4", "bc5")),
                           "dlt_ltu_counts_rows": sum(batches.values()),
                           **{f"dlt_{f}_regions": batches[f] for f in ("bc1", "bc2", "bc3")},
                           **{f"dlt_{f}_transform_rows": batches[f] for f in BATCH_FORMATS}}
            got = {name: counts.get(name, 0) for name in want_counts}
            carried = {fmt: sum(1 for rel in want if fmt_of[rel] == fmt) for fmt in batches}
            if got != want_counts or any(batches[f] >= carried[f] for f in BATCH_FORMATS):
                fail(f"cli medium: launches {got}, expected {want_counts} for batches "
                     f"{batches} of files {carried}")
            results["medium"].update(batches=batches, carried=carried)
            for label, flags in (("threads1_batch", ["--batch"]),
                                 ("threads1_no_batch", ["--no-batch"])):
                outs = transform(f"medium/transform_{label}", "medium", "--threads", "1",
                                 *flags)
                if outs != (batched if flags == ["--batch"] else per_file):
                    fail(f"cli medium {label}: differs from the default --threads")
                shutil.rmtree(tmpdir / f"cli_medium/transform_{label}")
        for label, outs in (("transform_batch", batched), ("transform_no_batch", per_file)):
            broken = ()
            if preset == "optimal" and label == "transform_batch":
                # a truncated transformed file: only it fails, and only it is missing
                rel = "bc1/zz_truncated.dds"
                data = outs[min(r for r in outs if r.startswith("bc1/"))]
                (tmpdir / f"cli_{preset}/{label}" / rel).write_bytes(data[:len(data) // 2])
                broken = (rel,)
            for flag in ("--batch", "--no-batch"):
                unlabel = f"{preset}/untransform_{label[len('transform_'):]}{flag[1:]}"
                if preset == "medium" and label == "transform_batch" and flag == "--batch":
                    made = []

                    class Recorded(pipeline.UntransformBatchProcessor):
                        def __init__(self, *args, **kwargs):
                            super().__init__(*args, **kwargs)
                            made.append(self)

                    original_un = pipeline.UntransformBatchProcessor
                    pipeline.UntransformBatchProcessor = Recorded
                    try:
                        untransform(unlabel, f"{preset}/{label}", flag, broken)
                    finally:
                        pipeline.UntransformBatchProcessor = original_un
                    counts = path_launches[f"cli/{unlabel}"]
                    unbatches = {p.fmt: p.batches for p in made if p.fmt in BATCH_FORMATS}
                    if any(counts.get(f"dlt_{fmt}_untransform", 0) != n
                           or n >= sum(1 for rel in info if fmt_of[rel] == fmt)
                           for fmt, n in unbatches.items()):
                        fail(f"cli medium load path: launches {counts} for batches "
                             f"{unbatches}")
                    results["medium"]["untransform_batches"] = unbatches
                else:
                    untransform(unlabel, f"{preset}/{label}", flag, broken)
        shutil.rmtree(tmpdir / f"cli_{preset}")
    for preset in CLI_PRESETS:
        ref = CLI_REFERENCE[preset]
        results[preset]["reference"] = ref.get("sha256", ref["jax_sha256"])
        results[preset]["matches_reference"] = digests[preset] == results[preset]["reference"]
    if not (results["low"]["matches_reference"] and results["medium"]["matches_reference"]):
        fail(f"cli: the low or medium tree differs from the reference: "
             f"{ {p: results[p] for p in ('low', 'medium')} }")
    # a small tree with --profile: the trace names one of the port's kernels
    prof = tmpdir / "cli_profile"
    rc, _ = run("profile", ["--profile", str(prof), "transform", str(src / "rgba8888"),
                            str(tmpdir / "cli_profile_out"), "--preset", "medium"],
                src / "rgba8888")
    if rc != 0:
        fail(f"cli --profile: exit code {rc}")
    names = set()
    for source in (Path(__file__).resolve().parent / CSRC).glob("*.cu"):
        names.update(re.findall(r"^(\w+_kernel)\(", source.read_text(), re.M))
    traces = list(prof.glob("*.json"))
    named = sorted(name for name in names
                   if any(name in t.read_text() for t in traces))
    if not named:
        fail(f"cli --profile: no trace in {prof} names a kernel of {sorted(names)}")
    results["profile"] = {"traces": [t.name for t in traces], "kernels_named": named}
    shutil.rmtree(src)
    return results


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dxt_lossless_transform_tpu_torch import backend, parallel
    from dxt_lossless_transform_tpu_torch.api import (
        Bc1AutoTransformBuilder, Bc2AutoTransformBuilder, Bc3AutoTransformBuilder,
        Bc4AutoTransformBuilder, Bc5AutoTransformBuilder, Bc6hAutoTransformBuilder,
        Bc6hManualTransformBuilder, Bc7AutoTransformBuilder, Bc7ManualTransformBuilder,
        RgbAutoTransformBuilder,
    )
    from dxt_lossless_transform_tpu_torch.errors import (
        Bc6hValidationError, Bc7ValidationError, RgbValidationError,
    )
    from dxt_lossless_transform_tpu_torch.estimate import cuda_ltu, ltu, zstd
    from dxt_lossless_transform_tpu_torch.estimate.ltu import (
        DEFAULT_OFFSETS, LtuEstimation, coverage_scores, offset_weight,
    )
    from dxt_lossless_transform_tpu_torch.formats import file_io
    from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
    from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
    from dxt_lossless_transform_tpu_torch.ops import auto, bc45, bc6h, bc7, rgb
    from dxt_lossless_transform_tpu_torch.ops import bc1 as ops_bc1, bc2 as ops_bc2
    from dxt_lossless_transform_tpu_torch.ops import bc3 as ops_bc3
    from dxt_lossless_transform_tpu_torch.parallel import sharded
    from dxt_lossless_transform_tpu_torch.ops.cuda import channels, planes, regions, shuffle
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC2_COMPREHENSIVE_CANDIDATES,
        BC2_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES, BC3_FAST_CANDIDATES,
        BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, RGB_FAST_CANDIDATES,
        Bc1TransformSettings, Bc2TransformSettings, Bc3TransformSettings,
        Bc4TransformSettings, Bc5TransformSettings, Bc7TransformSettings,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import (
        MODE_BYTE0, MODE_SORT_EDGES, bc7_realistic, bc_blocks, chain_blocks, make_dds,
        make_dx10_dds, make_uncompressed_dds, mode_sort_edges,
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
    near = tuple(k for k in ks if k != 3)  # see FAR_OFFSETS
    prefix = tuple(ks[:5])  # see FAR_OFFSETS
    dds = {fmt: make_dds(fmt, SIZE, SIZE, MIPS, seed=SEED) for fmt in FORMATS}
    for fmt, data in dds.items():
        if hashlib.sha256(data).hexdigest() != FILE_SHA256[fmt]:
            fail(f"make_dds gave another {fmt} file than the reference run")
    payload = {fmt: data[0x80:] for fmt, data in dds.items()}
    max_err = {name: 0 for name in (*KERNELS, *ROWS_KERNELS)}

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
    # the generic count kernel: the main file's BC3 rows, and rows that repeat with
    # periods beyond the halo so that the far offsets match
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
        for offsets in (FAR_OFFSETS, LADDER_40, near, prefix):
            compare_counts(rows, rows.shape[1], offsets,
                           f"generic ladder of {len(offsets)}, rows {tuple(rows.shape)}")
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
    # the counting sort's edge chunks, each format with its own ids, in every setting
    for fmt, fmt_id in ms_fmt.items():
        per_id = len(MODE_BYTE0[fmt]) * planes.SORT_CHUNK_BLOCKS + 1
        for pattern in MODE_SORT_EDGES:
            for n in MODE_SORT_EDGE_SIZES + (per_id,):
                x = backend.upload(mode_sort_edges(fmt, n, pattern, seed=n), dev)
                for sort, split in settings_4:
                    what = f"{fmt} n={n} {pattern} sort={sort} planes={split}"
                    t = planes.bc7_transform(x, fmt_id, sort, split)
                    compare("dlt_bc7_transform", t,
                            planes.bc7_transform_plain(x, fmt_id, sort, split), what)
                    compare("dlt_bc7_untransform", planes.bc7_untransform(t, n, sort, split),
                            x, f"{what} round trip")
    # the transform into a row at each byte offset of a larger tensor, as the search
    # writes its candidates: every misalignment of the mode stream, the sorted blocks
    # and the plane rows; the bytes around the row stay as they were
    n_row = 8193
    for fmt, fmt_id in ms_fmt.items():
        x = backend.upload(mode_sort_edges(fmt, n_row, "every_id", seed=n_row), dev)
        for sort, split in settings_4:
            length = planes.transformed_len(n_row, sort)
            want = planes.bc7_transform_plain(x, fmt_id, sort, split)
            for offset in MODE_SORT_OFFSETS:
                buf = torch.full((length + 32,), 0xAB, dtype=torch.uint8, device=dev)
                planes.bc7_transform(x, fmt_id, sort, split, out=buf[offset:offset + length])
                what = (f"{fmt} n={n_row} sort={sort} planes={split} into a row at "
                        f"offset {offset}")
                compare("dlt_bc7_transform", buf[offset:offset + length], want, what)
                outside = torch.cat([buf[:offset], buf[offset + length:]])
                compare("dlt_bc7_transform", outside, torch.full_like(outside, 0xAB),
                        f"{what}, the bytes around it")
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
    # the word deinterleave: both k, every N of the list
    for k in (2, 4):
        for n_words in WORD_SIZES:
            xw = torch.from_numpy(rng.integers(-2**31, 2**31, k * n_words, np.int32)).to(dev)
            for i, (got, want) in enumerate(zip(planes.deinterleave_words(xw, k),
                                                planes.deinterleave_words_plain(xw, k))):
                compare("dlt_deinterleave_words", got, want, f"k={k} N={n_words} stream {i}")
    # the per-row count kernel: lengths from 0 to the row's (0-3 and odd ones
    # included) on random rows and on the periodic rows whose far offsets match,
    # with the three ladders; against the scalar kernel where every row has one
    # length; 70,000 rows at their own lengths
    rows_len = 140_002
    row_lengths = [0, 1, 2, 3, 4, 5, 7, 4099, 8191, 8195, 65_537, 70_001, rows_len - 1,
                   rows_len]
    per_row = [(torch.from_numpy(rng.integers(0, 3, (len(row_lengths), rows_len),
                                              np.uint8)).to(dev),
                torch.tensor(row_lengths)),
               (torch.cat(far_rows[2:]), torch.tensor([rows_len, 100_001, 65_537]))]
    for rows, valid in per_row:
        for offsets in (ks, FAR_OFFSETS, LADDER_40, near, prefix):
            weights = [offset_weight(k) for k in offsets]
            compare("dlt_ltu_counts_rows", cuda_ltu.ltu_counts(rows, valid, offsets, weights),
                    cuda_ltu.ltu_counts_plain(rows, valid, offsets, weights),
                    f"per-row lengths {valid.tolist()}, ladder of {len(offsets)}")
            for v in (0, 3, 70_001, rows_len):
                compare("dlt_ltu_counts_rows",
                        cuda_ltu.ltu_counts(rows, torch.full_like(valid, v), offsets, weights),
                        cuda_ltu.ltu_counts(rows, v, offsets, weights),
                        f"every row at {v} against the scalar kernel, ladder of "
                        f"{len(offsets)}")
    many_valid = torch.from_numpy(rng.integers(0, 13, MANY_ROWS))
    compare("dlt_ltu_counts_rows", cuda_ltu.ltu_counts(many, many_valid, ks, ws),
            cuda_ltu.ltu_counts_plain(many, many_valid, ks, ws),
            f"{MANY_ROWS} rows at their own lengths")
    # every batch of the batch corpus, at the shapes the batch path gives the kernels:
    # for BC1-BC5, each batch as BatchProcessor assembles it (up to 16 files of one
    # bucket: four 2048x2048 chains in 524,288 blocks, ragged 5,463 and 5,041 in
    # 8,192, three of 3 blocks in 2,048, ...), the deinterleave, region and
    # untransform kernels at n = B·bucket blocks (the untransform in every setting,
    # on the transform kernel's output), and the per-row count kernel on the rows
    # the step scores, each at its own valid length; for BC7/BC6H and RGB, the count
    # kernel on the rows the processors score. The step's count calls are recorded
    # (ltu.ltu_counts wrapped while it runs) and each is repeated beside the plain
    # version.
    corpus = {fmt: batch_corpus(fmt) for fmt in
              BATCH_FORMATS + ("bc7", "bc6h") + tuple(fmt.lower() for fmt in RGB)}
    scored = []
    real_ltu_counts = ltu.ltu_counts

    def record_counts(rows, valid, offsets, weights):
        scored.append((rows, valid, tuple(offsets), tuple(weights)))
        return real_ltu_counts(rows, valid, offsets, weights)

    def compare_scored(what: str) -> None:
        if not scored:
            fail(f"{what}: the step made no count call")
        for rows, valid, offsets, weights in scored:
            if not isinstance(valid, cuda_ltu.RowLengths):
                fail(f"{what}: a count call without per-row lengths on the card")
            compare("dlt_ltu_counts_rows",
                    cuda_ltu.ltu_counts(rows, valid, offsets, weights),
                    cuda_ltu.ltu_counts_plain(rows, valid.lengths, offsets, weights),
                    f"{what}: {tuple(rows.shape)} rows at lengths "
                    f"{sorted(set(valid.lengths.tolist()))}")
        batch_rows_checked.append([tuple(rows.shape) for rows, *_ in scored])
        scored.clear()

    def shuffle_args(s) -> tuple:
        if isinstance(s, (Bc4TransformSettings, Bc5TransformSettings)):
            return (s.split_endpoints,)
        if isinstance(s, Bc3TransformSettings):
            return (int(s.decorrelation_mode), s.split_alpha_endpoints,
                    s.split_colour_endpoints)
        return (int(s.decorrelation_mode), s.split_colour_endpoints)

    batch_settings = {"bc1": Bc1TransformSettings, "bc2": Bc2TransformSettings,
                      "bc3": Bc3TransformSettings, "bc4": Bc4TransformSettings,
                      "bc5": Bc5TransformSettings}
    batch_blocks_checked, batch_rows_checked = {}, []
    ltu.ltu_counts = record_counts
    try:
        for fmt in BATCH_FORMATS:
            proc = parallel.BatchProcessor(fmt, max_batch=BATCH_MAX)
            data = corpus[fmt]
            wpb = proc.cfg["words"]
            transform = getattr(shuffle, f"{fmt}_transform")
            untransform = getattr(shuffle, f"{fmt}_untransform")
            untransform_plain = getattr(shuffle, f"{fmt}_untransform_plain")
            batch_blocks_checked[fmt] = []
            for chunk, flats, valid in proc._prepare_batches(data, [None] * len(data)):
                bucket = flats.shape[1] // wpb
                n = len(chunk) * bucket
                what = f"{fmt} batch of {len(chunk)} files in the {bucket}-block bucket"
                x = backend.to_device(flats, dev)
                for i, (got, want) in enumerate(zip(
                        planes.deinterleave_words(x.reshape(-1), wpb),
                        planes.deinterleave_words_plain(x.reshape(-1), wpb))):
                    compare("dlt_deinterleave_words", got, want, f"{what}, stream {i}")
                xb = x.view(torch.uint8).reshape(-1)
                if fmt == "bc3":
                    akeys, ckeys = sharded._bc3_keys(proc._cand_key)[:2]
                    for part, got, want in zip(("alpha", "colour"),
                                               regions.bc3_regions(xb, akeys, ckeys),
                                               regions.bc3_regions_plain(xb, akeys, ckeys)):
                        compare("dlt_bc3_regions", got, want, f"{what}, {part}")
                elif fmt in ("bc1", "bc2"):
                    keys = auto.distinct(proc._cand_key)[0]
                    compare(f"dlt_{fmt}_regions", getattr(regions, f"{fmt}_regions")(xb, keys),
                            getattr(regions, f"{fmt}_regions_plain")(xb, keys), what)
                rows, best = proc._step(x, valid)
                compare_scored(what)
                ns, bs = [v // 4 for v in valid], proc.cfg["block_size"]
                plain_rows = shuffle.transform_rows_plain(fmt, x.cpu(), ns, best.cpu(),
                                                          proc._cand_key)
                for r, n_r in enumerate(ns):
                    compare(f"dlt_{fmt}_transform_rows", rows[r, :bs * n_r],
                            plain_rows[r, :bs * n_r].to(dev), f"{what}, row {r}")
                for st in batch_settings[fmt].all_combinations():
                    t = transform(xb, *shuffle_args(st))
                    u = untransform(t, *shuffle_args(st))
                    compare(f"dlt_{fmt}_untransform", u,
                            untransform_plain(t, *shuffle_args(st)), f"{what} {st}")
                    compare(f"dlt_{fmt}_untransform", u, xb, f"{what} {st} round trip")
                batch_blocks_checked[fmt].append(n)
        for fmt in ("bc7", "bc6h"):
            parallel.ModeSortBatchProcessor(fmt, max_batch=BATCH_MAX).process(corpus[fmt])
            compare_scored(f"{fmt} mode-sort batches")
        for layout in (fmt.lower() for fmt in RGB):
            parallel.RgbBatchProcessor(layout, LtuEstimation(), max_batch=BATCH_MAX).process(
                corpus[layout])
            compare_scored(f"{layout} batches")
    finally:
        ltu.ltu_counts = real_ltu_counts
    # the windowed count kernel: the rows each BC1 corpus batch scores (every
    # candidate key's colour row of each file, at the file's own valid length; the
    # 524,288-block bucket's batch is 16 rows of 2,097,152 bytes) cut into 1, 2 and 8
    # shards with their halos (chunks of 1 KiB to 2 MiB, shorter and longer than the
    # halo), with three ladders: each shard's window against the plain version, and
    # the shards' sum against the per-row kernel on the uncut rows
    window_cuts = []
    bc1_proc = parallel.BatchProcessor("bc1", max_batch=BATCH_MAX)
    bc1_data = corpus["bc1"]
    for chunk, flats, valid in bc1_proc._prepare_batches(bc1_data, [None] * len(bc1_data)):
        rows = sharded._colour_rows_batched(
            backend.to_device(flats, dev), [v // 4 for v in valid], sharded._BC1_CANDIDATES,
            2, regions.bc1_regions)
        keys = rows.shape[1]
        rows = rows.reshape(-1, rows.shape[2])
        lengths = torch.tensor([v for v in valid for _ in range(keys)])
        for offsets in (ks, WINDOW_FAR, WINDOW_LADDER_40, near, prefix):
            weights = [offset_weight(k) for k in offsets]
            uncut = cuda_ltu.ltu_counts(rows, lengths, offsets, weights)
            for nb in WINDOW_SHARDS:
                lc = -(-rows.shape[1] // nb)
                padded = torch.nn.functional.pad(
                    rows, (WINDOW_SPAN, WINDOW_SPAN + nb * lc - rows.shape[1]))
                total = torch.zeros_like(uncut)
                what = (f"BC1 batch rows {tuple(rows.shape)} in {nb} shards, ladder of "
                        f"{len(offsets)}")
                for s in range(nb):
                    win = padded[:, s * lc:(s + 1) * lc + 2 * WINDOW_SPAN].contiguous()
                    got = cuda_ltu.ltu_counts_windowed(win, lengths, s * lc - WINDOW_SPAN,
                                                       offsets, weights)
                    compare("dlt_ltu_counts_windowed", got, cuda_ltu.ltu_counts_windowed_plain(
                        win, lengths, s * lc - WINDOW_SPAN, offsets, weights),
                        f"{what}, shard {s}")
                    total += got
                compare("dlt_ltu_counts_windowed", total, uncut,
                        f"{what}: the shards' sum against the uncut rows")
                window_cuts.append([list(rows.shape), nb, lc, len(offsets)])
    # and each kernel call of the mesh paths, at the shapes they give the kernels, on
    # every mesh of MESH_SHAPES: the mesh phase's paths run with each kernel wrapper
    # that the sharded steps call replaced by one that holds the kernel's result
    # against its plain version on the same inputs (the windowed count kernel on each
    # position's windows; the deinterleave and region kernels on each position's
    # words, Bl files of bucket / blocks blocks; the untransform kernels on each
    # position's streams in untransform_step; the mode-sort kernel on each file's part
    # of a position in modesort_transform_step)
    meshes = {"1x1": parallel.make_mesh(), "1x8": parallel.make_mesh(devices=[dev] * 8),
              "3x2": parallel.make_mesh(devices=[dev] * 6)}
    for name, mesh in meshes.items():
        if mesh.shape != MESH_SHAPES[name] or set(mesh.devices.flat) != {dev}:
            fail(f"make_mesh gave {mesh} for the {name} mesh")

    def restore(mesh, fmt: str, results) -> list:
        """Every BC1-BC5 result back through ``untransform_step``: one step per
        (settings, block count), its files axis filled by repeating the last file."""
        bs = BLOCK_SIZE[fmt.upper()]
        files = mesh.shape["files"]
        groups: dict = {}
        for r in results:
            if r.transformed:
                groups.setdefault((r.settings, len(r.transformed) // bs), []).append(r)
        back = {}
        for (settings, n), rs in groups.items():
            rs = rs + rs[-1:] * (-len(rs) % files)
            streams, pos = [], 0
            for bpb in sharded._untransform_kernel(fmt, settings)[1]:
                streams.append(torch.from_numpy(np.stack([
                    np.frombuffer(r.transformed, np.uint8, bpb * n, pos * n) for r in rs]))
                    .to(dev))
                pos += bpb
            words = parallel.untransform_step(mesh, fmt, settings)(*streams).cpu().numpy()
            for row, r in enumerate(rs):
                back[r.index] = words[row].tobytes()
        return [back.get(i, b"") for i in range(len(results))]

    def bc7_batch(mesh) -> tuple:
        """The BC7 corpus as one ``modesort_transform_step`` batch: (its files, their
        block counts, the (B, 4·Np) words on the card, each file's blocks padded to a
        multiple of 4096 x the blocks axis)."""
        data = [d for d in corpus["bc7"] if d]
        ns = [len(d) // 16 for d in data]
        step_chunk = 4096 * mesh.shape["blocks"]
        words = np.zeros((len(data), 4 * (-(-max(ns) // step_chunk) * step_chunk)), np.int32)
        for row, d in enumerate(data):
            words[row, :len(d) // 4] = np.frombuffer(d, np.int32)
        return data, ns, torch.from_numpy(words).to(dev)

    def windowed_plain(rows, valid_rows, pos0, offsets, weights):
        return cuda_ltu.ltu_counts_windowed_plain(rows, valid_rows.lengths, pos0, offsets,
                                                  weights)

    mesh_checked = [
        (sharded, "ltu_counts_windowed", windowed_plain, "dlt_ltu_counts_windowed"),
        (sharded, "deinterleave_words", planes.deinterleave_words_plain,
         "dlt_deinterleave_words"),
        (planes, "bc7_transform", planes.bc7_transform_plain, "dlt_bc7_transform"),
        *((regions, f"{fmt}_regions", getattr(regions, f"{fmt}_regions_plain"),
           f"dlt_{fmt}_regions") for fmt in ("bc1", "bc2", "bc3")),
        *((shuffle, f"{fmt}_untransform", getattr(shuffle, f"{fmt}_untransform_plain"),
           f"dlt_{fmt}_untransform") for fmt in BATCH_FORMATS)]
    mesh_calls = {}  # per mesh path: each kernel's compared calls
    # per mesh path: the windowed count launches' blocks (grid x rows) and the blocks
    # the card holds at once, as the default-ladder kernel chooses its tiles
    window_blocks = {}

    def checked_path(label: str, fn, expect) -> None:
        """Run ``fn`` with every wrapper of ``mesh_checked`` comparing each of its
        calls with the plain version; each kernel of ``expect`` must be called."""
        calls = mesh_calls[label] = {}
        real = [getattr(module, attr) for module, attr, _, _ in mesh_checked]

        def checking(wrapper, plain, kernel):
            def call(*args):
                got, want = wrapper(*args), plain(*args)
                pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
                shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
                if isinstance(got, tuple) and len(got) != len(want):
                    fail(f"{kernel} mesh {label}: {len(got)} outputs, plain {len(want)}")
                for i, (g, w) in enumerate(pairs):
                    compare(kernel, g, w, f"mesh {label}: inputs {shapes}, output {i}")
                calls[kernel] = calls.get(kernel, 0) + 1
                if kernel == "dlt_ltu_counts_windowed":
                    rows = cuda_ltu.byte_rows(args[0])
                    shape = cuda_ltu.launch_shape(rows.shape[0], rows.shape[1] - 2 * WINDOW_SPAN,
                                                  "windowed", dev)
                    seen = window_blocks.setdefault(label, {
                        "launches": 0, "min_blocks": shape["blocks"], "max_blocks": 0,
                        "resident": shape["resident"], "below_resident": 0})
                    seen["launches"] += 1
                    seen["min_blocks"] = min(seen["min_blocks"], shape["blocks"])
                    seen["max_blocks"] = max(seen["max_blocks"], shape["blocks"])
                    seen["below_resident"] += shape["blocks"] < shape["resident"]
                return got
            return call

        for (module, attr, plain, kernel), wrapper in zip(mesh_checked, real):
            setattr(module, attr, checking(wrapper, plain, kernel))
        try:
            fn()
        finally:
            for (module, attr, _, _), wrapper in zip(mesh_checked, real):
                setattr(module, attr, wrapper)
        if [k for k in expect if not calls.get(k)]:
            fail(f"mesh {label}: compared calls {calls}, expected each of {expect}")

    def region_kernels(fmt: str) -> list:
        return [f"dlt_{fmt}_regions"] if fmt in ("bc1", "bc2", "bc3") else []

    for name, mesh in meshes.items():
        for fmt in BATCH_FORMATS:
            checked_path(f"{name}/{fmt}", lambda: restore(mesh, fmt, parallel.BatchProcessor(
                fmt, mesh=mesh, max_batch=BATCH_MAX).process(corpus[fmt])),
                ["dlt_ltu_counts_windowed", f"dlt_{fmt}_untransform",
                 *(region_kernels(fmt) or ["dlt_deinterleave_words"])])
        for fmt in BATCH_HOST_SCORED:
            checked_path(f"{name}/{fmt}_zstd1", lambda: restore(
                mesh, fmt, parallel.BatchProcessor(
                    fmt, mesh=mesh, max_batch=BATCH_MAX,
                    estimator=zstd.ZstdEstimation(1)).process(corpus[fmt])),
                [f"dlt_{fmt}_untransform", *region_kernels(fmt)])
        _, ns, words = bc7_batch(mesh)
        checked_path(f"{name}/bc7_modesort", lambda: parallel.modesort_transform_step(
            mesh, "bc7")(words, ns), ["dlt_bc7_transform"])
    for fmt in ("bc1", "bc3"):
        checked_path(f"1x8/{fmt}_4096", lambda: restore(
            meshes["1x8"], fmt, parallel.BatchProcessor(fmt, mesh=meshes["1x8"], max_batch=1)
            .process([payload[fmt.upper()]])),
            ["dlt_ltu_counts_windowed", f"dlt_{fmt}_untransform", f"dlt_{fmt}_regions"])
    emit("check", t0, block_counts=checked, max_abs_err=max_err,
         window_cuts=window_cuts, mesh_calls=mesh_calls, window_blocks=window_blocks,
         batch_blocks=batch_blocks_checked, batch_count_rows=batch_rows_checked,
         word_counts=list(WORD_SIZES), per_row_lengths=row_lengths,
         far_counts=far_counts, many_rows=MANY_ROWS, many_rows_count_sum=many_rows_sum,
         mode_sort_block_counts=list(MODE_SORT_SIZES),
         mode_sort_edges={"patterns": list(MODE_SORT_EDGES),
                          "block_counts": list(MODE_SORT_EDGE_SIZES),
                          "offsets": list(MODE_SORT_OFFSETS)},
         guard=guard_checks,
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

    # ---- 5. the batch corpus, through the pipeline's processors -------------------------
    t0 = time.perf_counter()
    per_file_auto = {"bc1": auto.transform_bc1_auto, "bc2": auto.transform_bc2_auto,
                     "bc3": auto.transform_bc3_auto, "bc4": bc45.transform_bc4_auto,
                     "bc5": bc45.transform_bc5_auto, "bc7": bc7.transform_bc7_auto,
                     "bc6h": bc6h.transform_bc6h_auto}
    for layout in (fmt.lower() for fmt in RGB):
        per_file_auto[layout] = (lambda d, est, _l=layout: rgb.transform_rgb_auto(d, _l, est))
    batch_results = {}
    batch_out = {}  # each path's results, which the mesh phase must equal

    def batch_path(label: str, fmt: str, proc):
        """One path: the batch transform of the corpus of ``fmt`` and its batched
        load path, with the launch counts set to 0 just before and read just
        after. Returns (results, counts, the load path's processor)."""
        data = corpus[fmt]
        sync()
        backend.reset_launch_counts()
        t = time.perf_counter()
        results = proc.process(data)
        sync()
        wall[f"batch_{label}_transform_s"] = time.perf_counter() - t
        unproc = parallel.UntransformBatchProcessor(fmt, max_batch=BATCH_MAX)
        t = time.perf_counter()
        back = unproc.process([(r.transformed, r.settings) for r in results])
        sync()
        wall[f"batch_{label}_untransform_s"] = time.perf_counter() - t
        counts = {name: count for name, count in backend.LAUNCHES.items() if count}
        path_launches[f"batch/{label}"] = counts
        batch_out[label] = results
        if [r.index for r in results] != list(range(len(data))):
            fail(f"batch {label}: results out of submission order")
        if back != data:
            fail(f"batch {label}: a restored payload differs from the input")
        bad = [i for i, (r, d) in enumerate(zip(results, data))
               if d and per_file_auto[fmt](d, proc.estimator if label.endswith("zstd1")
                                           else LtuEstimation()) != (r.transformed,
                                                                     r.settings)]
        expected = BATCH_REFERENCE[fmt].get("per_file_differs", []) \
            if not label.endswith("zstd1") else []
        if bad != expected:
            fail(f"batch {label}: payloads {bad} differ from the per-file auto-search "
                 f"(expected {expected})")
        return results, counts, unproc

    def digest(results) -> str:
        h = hashlib.sha256()
        for r in results:
            h.update(r.transformed)
        return h.hexdigest()

    for fmt in BATCH_FORMATS:
        proc = parallel.BatchProcessor(fmt, max_batch=BATCH_MAX)
        results, counts, unproc = batch_path(fmt, fmt, proc)
        want = {"dlt_ltu_counts_rows": proc.batches,
                f"dlt_{fmt}_transform_rows": proc.batches,
                f"dlt_{fmt}_untransform": unproc.batches}
        if fmt in ("bc1", "bc2", "bc3"):
            want[f"dlt_{fmt}_regions"] = proc.batches
        else:
            want["dlt_deinterleave_words"] = proc.batches
        if counts != want:
            fail(f"batch {fmt}: launches {counts}, expected one of each kernel per "
                 f"batch: {want}")
        picks = [proc.candidates.index(r.settings) for r in results]
        ref = BATCH_REFERENCE[fmt]
        batch_results[fmt] = {"payloads": len(results), "batches": proc.batches,
                              "untransform_batches": unproc.batches, "picks": picks,
                              "sha256": digest(results)}
        if picks != ref["picks"] or batch_results[fmt]["sha256"] != ref["sha256"]:
            fail(f"batch {fmt}: picks or sha256 differ from the JAX package's: "
                 f"{batch_results[fmt]}")
    for fmt in BATCH_HOST_SCORED:
        proc = parallel.BatchProcessor(fmt, max_batch=BATCH_MAX,
                                       estimator=zstd.ZstdEstimation(1))
        results, counts, unproc = batch_path(f"{fmt}_zstd1", fmt, proc)
        want = {f"dlt_{fmt}_regions": proc.batches,
                f"dlt_{fmt}_transform_rows": proc.batches,
                f"dlt_{fmt}_untransform": unproc.batches}
        if counts != want:
            fail(f"batch {fmt} host-scored: launches {counts}, expected one of each "
                 f"kernel per batch: {want}")
        batch_results[f"{fmt}_zstd1"] = {
            "batches": proc.batches, "untransform_batches": unproc.batches,
            "picks": [proc.candidates.index(r.settings) for r in results],
            "sha256": digest(results)}
        batch_results[f"{fmt}_zstd1"]["sha256_matches_reference"] = \
            batch_results[f"{fmt}_zstd1"]["sha256"] == BATCH_REFERENCE[fmt]["host_sha256"]
    for fmt in ("bc7", "bc6h"):
        proc = parallel.ModeSortBatchProcessor(fmt, max_batch=BATCH_MAX)
        results, counts, unproc = batch_path(fmt, fmt, proc)
        shipped = [proc.settings.index(r.settings) for r in results]
        if counts.get("dlt_ltu_counts_rows") != proc.batches \
                or not counts.get("dlt_bc7_transform") \
                or (any(s.sort_by_mode or s.split_byte_planes for s in
                        (r.settings for r, d in zip(results, corpus[fmt]) if d))
                    and not counts.get("dlt_bc7_untransform")) \
                or set(counts) - {"dlt_bc7_transform", "dlt_bc7_untransform",
                                  "dlt_ltu_counts_rows"}:
            fail(f"batch {fmt}: launches {counts} for {proc.batches} batches")
        # the batch step's own picks, before the guard
        picks = proc.picks
        ref = BATCH_REFERENCE[fmt]
        batch_results[fmt] = {"payloads": len(results), "batches": proc.batches,
                              "picks": picks, "shipped": shipped,
                              "sha256": digest(results),
                              "shipped_matches_reference": shipped == ref["shipped"]}
        batch_results[fmt]["sha256_matches_reference"] = \
            batch_results[fmt]["sha256"] == ref["sha256"]
        if picks != ref["picks"]:
            fail(f"batch {fmt}: picks {picks} != reference {ref['picks']}")
    for layout in (fmt.lower() for fmt in RGB):
        proc = parallel.RgbBatchProcessor(layout, LtuEstimation(), max_batch=BATCH_MAX)
        results, counts, unproc = batch_path(layout, layout, proc)
        picks = [proc.settings.index(r.settings) for r in results]
        if counts.get("dlt_ltu_counts_rows") != proc.batches \
                or not counts.get("dlt_rgb_transform") \
                or set(counts) - {"dlt_rgb_transform", "dlt_rgb_untransform",
                                  "dlt_ltu_counts_rows"}:
            fail(f"batch {layout}: launches {counts} for {proc.batches} batches")
        ref = BATCH_REFERENCE[layout]
        batch_results[layout] = {"payloads": len(results), "batches": proc.batches,
                                 "picks": picks, "sha256": digest(results)}
        if picks != ref["picks"] or batch_results[layout]["sha256"] != ref["sha256"]:
            fail(f"batch {layout}: picks or sha256 differ from the JAX package's: "
                 f"{batch_results[layout]}")
    emit("batch", t0, payloads={fmt: len(d) for fmt, d in corpus.items()},
         bytes={fmt: sum(map(len, d)) for fmt, d in corpus.items()},
         launches={k: v for k, v in path_launches.items() if k.startswith("batch/")},
         results=batch_results,
         wall={k: v for k, v in wall.items() if k.startswith("batch_")})

    # ---- 6. the mesh: the same corpus, sharded ------------------------------------------
    t0 = time.perf_counter()

    def mesh_path(label: str, fn):
        """One path of the mesh phase: its counts set to 0 just before, read just
        after. Returns (what ``fn`` returns, the counts)."""
        sync()
        backend.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        sync()
        wall[f"mesh_{label.replace('/', '_')}_s"] = time.perf_counter() - t
        counts = {name: count for name, count in backend.LAUNCHES.items() if count}
        path_launches[f"mesh/{label}"] = counts
        return out, counts

    def same(got, want) -> bool:
        return [(r.index, r.transformed, r.settings) for r in got] == \
            [(r.index, r.transformed, r.settings) for r in want]

    mesh_results = {}
    for name, mesh in meshes.items():
        for fmt in BATCH_FORMATS:
            label = f"{name}/{fmt}"
            results, counts = mesh_path(label, lambda: parallel.BatchProcessor(
                fmt, mesh=mesh, max_batch=BATCH_MAX).process(corpus[fmt]))
            if not same(results, batch_out[fmt]):
                fail(f"mesh {label}: results differ from the single-device batch")
            if not counts.get("dlt_ltu_counts_windowed") or counts.get("dlt_ltu_counts_rows"):
                fail(f"mesh {label}: launches {counts}; the windowed count kernel must "
                     f"score it, the per-row one not")
            back, back_counts = mesh_path(f"{label}/load", lambda: restore(mesh, fmt, results))
            if back != corpus[fmt] or not back_counts.get(f"dlt_{fmt}_untransform"):
                fail(f"mesh {label}: untransform_step did not restore every file "
                     f"({back_counts})")
            mesh_results[label] = {"windowed_launches": counts["dlt_ltu_counts_windowed"],
                                   "untransform_launches": back_counts[f"dlt_{fmt}_untransform"]}
        for fmt in BATCH_HOST_SCORED:
            label = f"{name}/{fmt}_zstd1"
            results, counts = mesh_path(label, lambda: parallel.BatchProcessor(
                fmt, mesh=mesh, max_batch=BATCH_MAX,
                estimator=zstd.ZstdEstimation(1)).process(corpus[fmt]))
            if not same(results, batch_out[f"{fmt}_zstd1"]):
                fail(f"mesh {label}: results differ from the single-device batch")
            if not (counts.get(f"dlt_{fmt}_regions")
                    and counts.get(f"dlt_{fmt}_transform_rows")):
                fail(f"mesh {label}: launches {counts}")
            back, _ = mesh_path(f"{label}/load", lambda: restore(mesh, fmt, results))
            if back != corpus[fmt]:
                fail(f"mesh {label}: untransform_step did not restore every file")
        # the BC7 corpus through the mode-sort step: one batch, each file's blocks
        # padded to a multiple of 4096 x the blocks axis; each file's planes and mode
        # stream must be its sort+planes transform on one device
        data, ns, words = bc7_batch(mesh)
        label = f"{name}/bc7_modesort"
        (planes_out, modes_out), counts = mesh_path(
            label, lambda: parallel.modesort_transform_step(mesh, "bc7")(words, ns))
        if not counts.get("dlt_bc7_transform") or set(counts) != {"dlt_bc7_transform"}:
            fail(f"mesh {label}: launches {counts}")
        planes_out, modes_out = planes_out.cpu().numpy(), modes_out.cpu().numpy()
        sorted_ = [modes_out[row, :(n + 1) // 2].tobytes() + planes_out[row, :, :n].tobytes()
                   for row, n in enumerate(ns)]
        for d, got in zip(data, sorted_):
            if got != backend.download(planes.bc7_transform(backend.upload(d, dev),
                                                            planes.BC7, True, True)):
                fail(f"mesh {label}: a file's planes differ from its transform on one device")
        back, _ = mesh_path(f"{label}/load", lambda: parallel.UntransformBatchProcessor(
            "bc7", max_batch=BATCH_MAX).process(
                [(t, Bc7TransformSettings(True, True)) for t in sorted_]))
        if back != data:
            fail(f"mesh {label}: a file did not come back")
        mesh_results[label] = {"files": len(data), "blocks": words.shape[1] // 4,
                               "transform_launches": counts["dlt_bc7_transform"]}
    # the 4096x4096 BC1 and BC3 payloads as batches of one on the (1, 8) mesh, against
    # the main phase's per-file results
    for fmt in ("BC1", "BC3"):
        label = f"1x8/{fmt.lower()}_4096"
        results, counts = mesh_path(label, lambda: parallel.BatchProcessor(
            fmt.lower(), mesh=meshes["1x8"], max_batch=1).process([payload[fmt]]))
        search = auto.transform_bc1_auto if fmt == "BC1" else auto.transform_bc3_auto
        if (results[0].transformed, results[0].settings) != search(payload[fmt],
                                                                   LtuEstimation()):
            fail(f"mesh {label}: differs from the per-file auto-search")
        if not counts.get("dlt_ltu_counts_windowed") or counts.get("dlt_ltu_counts_rows"):
            fail(f"mesh {label}: launches {counts}")
        back, _ = mesh_path(f"{label}/load", lambda: restore(meshes["1x8"], fmt.lower(),
                                                             results))
        if back != [payload[fmt]]:
            fail(f"mesh {label}: the payload did not come back")
        mesh_results[label] = {"settings": str(results[0].settings),
                               "windowed_launches": counts["dlt_ltu_counts_windowed"]}
    emit("mesh", t0, meshes={name: str(mesh) for name, mesh in meshes.items()},
         launches={k: v for k, v in path_launches.items() if k.startswith("mesh/")},
         results=mesh_results, wall={k: v for k, v in wall.items() if k.startswith("mesh_")})

    # ---- 7. the CLI over a texture tree --------------------------------------------------
    t0 = time.perf_counter()
    cli_results = cli_phase(dev, corpus, {"bc1": dds["BC1"], "bc7": dds["BC7"]}, batch_out,
                            tmpdir, path_launches)
    emit("cli", t0, nvidia_smi=smi, **cli_results)

    # ---- 8. the normalize-then-auto search (Path A) --------------------------------------
    t0 = time.perf_counter()
    emit("normalize", t0, nvidia_smi=smi,
         **normalize_phase(dev, path_launches, compare,
                           lambda r, v, what: compare_counts(r, v, ks, what)),
         launches={k: v for k, v in path_launches.items() if k.startswith("normalize/")})

    # ---- 9. the endian matrix and the debug-endian commands (Path B) ----------------------
    t0 = time.perf_counter()
    emit("endian", t0, **endian_phase(dev, path_launches, tmpdir),
         launches=path_launches["endian"])
    # each kernel's launches on the main paths: the earlier slices', the batch, the
    # mesh, the CLI, the normalize and the endian ones
    launches = {name: sum(counts.get(name, 0) for counts in path_launches.values())
                for name in (*KERNELS, *ROWS_KERNELS)}

    # ---- 10. times ---------------------------------------------------------------------
    t0 = time.perf_counter()
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device=dev)

    def event_ms(fn, iters: int) -> float:
        return kernel_ms(fn, iters, flush)

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
            / int_rate * 1e3,
            shape=cuda_ltu.launch_shape(r.shape[0], valid - 3, "scalar", dev))

    # the host side of one transform and one untransform of each file, and the
    # copies of its payload apart: medians of 5, before the kernel timings below
    # fill the allocator's cache with their scratch
    def host_s(fn, reps: int = 5) -> float:
        times = []
        for _ in range(reps):
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
                bytes=moved, ops=ops,
                shape=planes.transform_launch_shape(n, fmt_id, sort, split, dev))
            timed[f"dlt_bc7_untransform/{label}"] = dict(
                ms=event_ms(lambda: planes.bc7_untransform(tm, n, sort, split), 20),
                plain_ms=event_ms(
                    lambda: planes.bc7_untransform_plain(tm, n, sort, split), 5),
                bytes=moved, ops=ops,
                shape=planes.untransform_launch_shape(n, sort, split, dev))
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
    # the word deinterleave at the largest batch's N, k = 2 (BC1, BC4) and 4 (BC2,
    # BC3, BC5), beside the one PyTorch call that computes it; each word read once
    # and written once
    for k in (2, 4):
        xw = torch.from_numpy(rng.integers(-2**31, 2**31, k * LARGEST_BATCH_N,
                                           np.int32)).to(dev)
        timed[f"dlt_deinterleave_words/k{k}"] = dict(
            ms=event_ms(lambda: planes.deinterleave_words(xw, k), 20),
            plain_ms=event_ms(lambda: planes.deinterleave_words_plain(xw, k), 5),
            library_ms=event_ms(lambda: xw.view(-1, k).t().contiguous(), 20),
            bytes=8 * k * LARGEST_BATCH_N, ops=0)
    # the per-row count kernel on the BC1 batch's rows: the four 2048x2048 chains of
    # the 524,288-block bucket, each candidate key's row cut at the file's length
    rows, n_big = bc1_batch_rows(corpus["bc1"], dev)
    valid_rows = torch.full((rows.shape[0],), 4 * n_big)
    # the lengths on the card with the longest from the host, as the batch and mesh
    # steps pass them (one copy a step)
    valid_on_card = cuda_ltu.device_lengths(valid_rows, dev)
    positions, compares = rows.shape[0] * (4 * n_big - 3), compares_needed(rows, 4 * n_big)
    timed["dlt_ltu_counts_rows/bc1_batch"] = dict(
        ms=event_ms(lambda: cuda_ltu.ltu_counts(rows, valid_on_card, ks, ws), 20),
        plain_ms=event_ms(lambda: cuda_ltu.ltu_counts_plain(rows, valid_rows, ks, ws), 3),
        scalar_ms=event_ms(lambda: cuda_ltu.ltu_counts(rows, 4 * n_big, ks, ws), 20),
        bytes=rows.shape[0] * 4 * n_big, positions=positions, compares=compares,
        ops=OPS_GRAM * positions + OPS_COMPARE * compares,
        issue_ms=(SASS_PER_POSITION * positions + SASS_PER_COMPARE * compares)
        / int_rate * 1e3,
        shape=cuda_ltu.launch_shape(rows.shape[0], 4 * n_big - 3, "rows", dev))
    compare("dlt_ltu_counts_rows", cuda_ltu.ltu_counts(rows, valid_on_card, ks, ws),
            cuda_ltu.ltu_counts_plain(rows, valid_rows, ks, ws), "the BC1 batch's timed rows")
    # the windowed count kernel on the same rows cut into 8 shards with their halos:
    # the 8 launches of one mesh scoring, each shard's window as the mesh step makes it,
    # timed as the sum of each launch's median (and so each plain call's).
    # Bytes: each shard's counted positions, the 4096 bytes before its first one and
    # the 3 after its last; operations and compares as for the uncut rows
    nb = 8
    windows, lc = shard_windows(rows, nb)
    counted = [min(max(4 * n_big - 3 - s * lc, 0), lc) for s in range(nb)]

    def shard(s: int):
        return lambda: cuda_ltu.ltu_counts_windowed(
            windows[s], valid_on_card, s * lc - WINDOW_SPAN, ks, ws)

    def shard_plain(s: int):
        return lambda: cuda_ltu.ltu_counts_windowed_plain(
            windows[s], valid_rows, s * lc - WINDOW_SPAN, ks, ws)

    timed["dlt_ltu_counts_windowed"] = dict(
        ms=sum(event_ms(shard(s), 20) for s in range(nb)),
        plain_ms=sum(event_ms(shard_plain(s), 3) for s in range(nb)),
        launches=nb, chunk=lc,
        shape=cuda_ltu.launch_shape(rows.shape[0], lc, "windowed", dev),
        bytes=rows.shape[0] * sum(c + 4096 + 3 for c in counted if c),
        positions=positions, compares=compares,
        ops=OPS_GRAM * positions + OPS_COMPARE * compares,
        issue_ms=(SASS_PER_POSITION * positions + SASS_PER_COMPARE * compares)
        / int_rate * 1e3)
    compare("dlt_ltu_counts_windowed", sum(shard(s)() for s in range(nb)),
            cuda_ltu.ltu_counts(rows, valid_rows, ks, ws),
            "the BC1 batch's timed rows in 8 shards against the uncut rows")
    del xw, rows, windows
    # each format's batch against a loop of the per-file entry points over the same
    # payloads, both directions, and the stages of one batch run with the device
    # synchronised around each (so that they do not overlap)
    per_file_untransform = {
        "bc1": ops_bc1.untransform, "bc2": ops_bc2.untransform, "bc3": ops_bc3.untransform,
        "bc4": bc45.untransform_bc4, "bc5": bc45.untransform_bc5, "bc7": bc7.untransform,
        "bc6h": bc6h.untransform}
    for layout in (fmt.lower() for fmt in RGB):
        per_file_untransform[layout] = (lambda p, st, _l=layout: rgb.untransform(p, _l, st))
    make_proc = {fmt: (lambda fmt=fmt, **kw: parallel.BatchProcessor(
        fmt, max_batch=BATCH_MAX, **kw)) for fmt in BATCH_FORMATS}
    make_proc.update({fmt: (lambda fmt=fmt, **kw: parallel.ModeSortBatchProcessor(
        fmt, max_batch=BATCH_MAX, **kw)) for fmt in ("bc7", "bc6h")})
    make_proc.update({layout: (lambda layout=layout, **kw: parallel.RgbBatchProcessor(
        layout, LtuEstimation(), max_batch=BATCH_MAX, **kw)) for layout in
        (fmt.lower() for fmt in RGB)})
    throughput = {}
    for fmt, data in corpus.items():
        files, nbytes = sum(1 for d in data if d), sum(map(len, data))
        results = make_proc[fmt]().process(data)
        entries = [(r.transformed, r.settings) for r in results]
        live = [(d, e) for d, e in zip(data, entries) if d]
        est = LtuEstimation()
        entry = {"files": files, "bytes": nbytes,
                 "batch_s": host_s(lambda: make_proc[fmt]().process(data), 3),
                 "per_file_s": host_s(lambda: [per_file_auto[fmt](d, est)
                                               for d, _ in live], 3),
                 "untransform_batch_s": host_s(lambda: parallel.UntransformBatchProcessor(
                     fmt, max_batch=BATCH_MAX).process(entries), 3),
                 "untransform_per_file_s": host_s(lambda: [
                     per_file_untransform[fmt](*e) for _, e in live], 3)}
        for key in ("batch", "per_file", "untransform_batch", "untransform_per_file"):
            entry[f"{key}_files_per_s"] = files / entry[f"{key}_s"]
            entry[f"{key}_MB_per_s"] = nbytes / entry[f"{key}_s"] / 1e6
        staged = make_proc[fmt](timing=True)
        staged.process(data)
        entry["batch_stages_s"] = staged.times.seconds
        unstaged = parallel.UntransformBatchProcessor(fmt, max_batch=BATCH_MAX, timing=True)
        unstaged.process(entries)
        if unstaged.times.seconds:
            entry["untransform_stages_s"] = unstaged.times.seconds
        throughput[fmt] = entry
    # host-scored mode on the payloads under 1 MiB (which the JAX package sends to its
    # host runtime; the port batches them): the batch against a loop of the per-file
    # search with the same estimator, the same results both ways
    small_files = {}
    for fmt in BATCH_HOST_SCORED:
        data = [d for d in corpus[fmt] if 0 < len(d) < 1 << 20]
        est = zstd.ZstdEstimation(1)
        if [(r.transformed, r.settings) for r in parallel.BatchProcessor(
                fmt, max_batch=BATCH_MAX, estimator=est).process(data)] != \
                [per_file_auto[fmt](d, est) for d in data]:
            fail(f"{fmt} host-scored: the batch and the per-file search of the small "
                 f"payloads give different results")
        small_files[fmt] = {
            "files": len(data), "bytes": sum(map(len, data)),
            "batch_s": host_s(lambda: parallel.BatchProcessor(
                fmt, max_batch=BATCH_MAX, estimator=est).process(data), 3),
            "per_file_s": host_s(lambda: [per_file_auto[fmt](d, est) for d in data], 3)}
    # each mesh's batch of each BC1-BC5 corpus beside the single-device batch above:
    # on one card a mesh can only be slower (nb launches where one did, and the
    # copies between its positions)
    mesh_batch = {}
    for name, mesh in meshes.items():
        for fmt in BATCH_FORMATS:
            data = corpus[fmt]
            mesh_batch[f"{name}/{fmt}"] = {
                "batch_s": host_s(lambda: parallel.BatchProcessor(
                    fmt, mesh=mesh, max_batch=BATCH_MAX).process(data), 3),
                "single_device_batch_s": throughput[fmt]["batch_s"]}
    # each rows kernel on its format's batch corpus as the batch step hands it over:
    # every batch's rows and the step's own picks, the block counts already on the
    # card (the step uploads them before the launch), timed as the sum of each
    # launch's median. Bytes: each file's blocks read and written once (the padding
    # neither); operations: BC1-BC3's colour pair, as the per-file kernels'
    for fmt in BATCH_FORMATS:
        proc = parallel.BatchProcessor(fmt, max_batch=BATCH_MAX)
        bs, batches = proc.cfg["block_size"], []
        code = shuffle.rows_code(fmt, proc._cand_key)
        for _, flats, valid in proc._prepare_batches(corpus[fmt], [None] * len(corpus[fmt])):
            x = backend.to_device(flats, dev)
            ns = [v // 4 for v in valid]
            best = proc._step(x, valid)[1]
            out = torch.empty((x.shape[0], 4 * x.shape[1]), dtype=torch.uint8, device=dev)
            batches.append((x, ns, torch.tensor(ns, device=dev), best, out, flats,
                            best.cpu()))
        blocks = sum(sum(b[1]) for b in batches)

        def rows_launch(i: int, plain: bool = False):
            x, ns, counts, best, out, x_host, best_host = batches[i]
            if plain:
                return lambda: shuffle.transform_rows_plain(fmt, x_host, ns, best_host,
                                                            proc._cand_key)
            return lambda: backend.launch(
                f"dlt_{fmt}_transform_rows", dev, x.data_ptr(), out.data_ptr(),
                counts.data_ptr(), best.data_ptr(), x.shape[0], out.shape[1] // bs, code,
                len(proc._cand_key))

        timed[f"dlt_{fmt}_transform_rows/batch"] = dict(
            ms=sum(event_ms(rows_launch(i), 20) for i in range(len(batches))),
            plain_ms=sum(event_ms(rows_launch(i, True), 3) for i in range(len(batches))),
            launches=len(batches), files=sum(1 for d in corpus[fmt] if d),
            bytes=2 * bs * blocks, ops=OPS_PAIR * blocks if fmt in ("bc1", "bc2", "bc3")
            else 0)
        del batches
    for entry in timed.values():
        bytes_ms = entry["bytes"] / rate * 1e3
        ops_ms = entry["ops"] / int_rate * 1e3
        entry["bound_ms"] = max(bytes_ms, ops_ms)
        entry["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"

    tmp.cleanup()
    emit("times", t0, kernels=timed, host=copies, batch=throughput,
         host_scored_small_files=small_files, mesh_batch=mesh_batch,
         note="kernel ms: CUDA-event medians with L2 flushed (a 64 MiB read) before "
              "each launch (the windowed cut: the sum of its launches' medians); "
              "host s: medians of 5, batch: medians of 3",
         run_seconds=time.perf_counter() - run_start)

    # ---- 11. the contract lines ----------------------------------------------------------
    # the row of each kernel: its COMPREHENSIVE shape where it has one, the count
    # kernel on the BC1 COMPREHENSIVE colour rows, as in earlier runs, the mode-sort
    # kernels in the BC7 file's shipped setting, sort and planes, and the RGB kernels
    # in the RGBA8888 file's shipped setting, split only
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        entry = (timed.get(name) or timed.get(f"{name}/bc7_sort_planes")
                 or timed.get(f"{name}/rgba8888_split") or timed.get(f"{name}/k2")
                 or timed.get(f"{name}/bc1_batch") or timed[f"{name}/comprehensive"])
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": entry["ms"], "plain_ms": entry["plain_ms"],
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
            "library_ms": entry.get("library_ms")})
    # the rows kernels on their formats' batch corpora
    for name, (source, replaces) in ROWS_KERNELS.items():
        entry = timed[f"{name}/batch"]
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
