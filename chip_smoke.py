#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dxt_lossless_transform_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as a JSON line with its wall time:

1. device: the card as ``nvidia-smi`` names it, its power limit, the PyTorch build;
2. build: the one ``nvcc`` call that builds the four kernels from ``csrc/`` into
   ``build/cuda/`` (skipped when that library is already built);
3. check: each kernel against its plain PyTorch version, both on the card, byte for
   byte and for scores as exact integers: all 8 settings, n in {1, 3, 2048,
   1,398,103} blocks, the FAST and COMPREHENSIVE candidate sets;
4. main: the production path through the entry points a user calls: a 4096x4096
   BC1 DDS file with its full 13-level mip chain (1,398,103 blocks, an
   11,184,824-byte payload) auto-transformed under the LTU estimator with the FAST
   and the COMPREHENSIVE candidates, then untransformed. The files must come back
   byte-identical, and the picks, the exact integer scores and the transformed
   file's sha256 must equal the JAX package's (constants below). Every kernel must
   have been launched in this phase;
5. times: CUDA-event medians of each kernel at the main path's shapes beside its
   plain version and its bound, and the wall time of one transform and one
   untransform of the file, with the host<->device copies shown apart.

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

# Reference constants, from the JAX package's exact integer scorer on the same file:
#     JAX_PLATFORMS=cpu python scripts/torch_port_reference.py
SIZE, MIPS, SEED = 4096, 13, 7
BLOCKS = 1398103
FILE_SHA256 = "e07169bacbb49da01c672e1141cf4975372d92b352185762f0b108300f56f94f"
REFERENCE = {
    "fast": {"scores": [132521388, 131980904, 132369283, 131964940],
             "pick": (1, True),
             "sha256": "8701ab8096774d6384ceb58a155050266fd59e6898ec343ba10cc774472ad5d6"},
    "comprehensive": {"scores": [132434502, 132521388, 131980904, 132370408,
                                 131967433, 131996919, 132369283, 131964940],
                      "pick": (1, True),
                      "sha256": "8701ab8096774d6384ceb58a155050266fd59e6898ec343ba10cc774472ad5d6"},
}

SOURCE = "dxt_lossless_transform_tpu_torch/csrc/bc1_kernels.cu"
REPLACES = {
    "dlt_bc1_transform": "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:157",
    "dlt_bc1_untransform": "dxt_lossless_transform_tpu/ops/pallas/shuffle.py:185",
    "dlt_bc1_regions": "dxt_lossless_transform_tpu/ops/pallas/regions.py:60",
    "dlt_ltu_counts": "dxt_lossless_transform_tpu/estimate/pallas_ltu.py:302",
}
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
    from dxt_lossless_transform_tpu_torch.api import Bc1AutoTransformBuilder
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
        BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, Bc1TransformSettings,
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
    dds = make_dds("BC1", SIZE, SIZE, MIPS, seed=SEED)
    if hashlib.sha256(dds).hexdigest() != FILE_SHA256:
        fail("make_dds gave another file than the reference run")
    payload = dds[0x80:]
    max_err = {name: 0 for name in REPLACES}

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

    rng = np.random.default_rng(SEED)
    checked = []
    for n in (1, 3, 2048, BLOCKS):
        host = payload if n == BLOCKS else rng.integers(0, 256, 8 * n, np.uint8).tobytes()
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
        for label, cand in (("fast", BC1_FAST_CANDIDATES),
                            ("comprehensive", BC1_COMPREHENSIVE_CANDIDATES)):
            key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints)
                        for c in cand)
            rows = regions.bc1_regions(x, key)
            compare("dlt_bc1_regions", rows, regions.bc1_regions_plain(x, key),
                    f"n={n} {label}")
            for valid in sorted({4 * n, max(4 * n - 5, 0)}):
                compare("dlt_ltu_counts", cuda_ltu.ltu_counts(rows, valid, ks, ws),
                        cuda_ltu.ltu_counts_plain(rows, valid, ks, ws),
                        f"n={n} {label} valid_len={valid}")
        checked.append(n)
    emit("check", t0, block_counts=checked, max_abs_err=max_err,
         launches=dict(backend.LAUNCHES))

    # ---- 4. the main path, through the entry points ---------------------------------
    t0 = time.perf_counter()
    handler = DdsHandler()
    bundles = {
        "fast": TransformBundle(bc1=Bc1AutoTransformBuilder(LtuEstimation())),
        "comprehensive": TransformBundle(bc1=Bc1AutoTransformBuilder(
            LtuEstimation()).use_all_decorrelation_modes(True)),
    }
    sync()
    backend.reset_launch_counts()
    wall = {}
    outs = {}
    for label, bundle in bundles.items():
        t = time.perf_counter()
        outs[label] = handler.transform_bundle(dds, bundle)
        wall[f"transform_{label}_s"] = time.perf_counter() - t
        t = time.perf_counter()
        back = handler.untransform(outs[label])
        wall[f"untransform_{label}_s"] = time.perf_counter() - t
        if back != dds:
            fail(f"{label}: the untransformed file differs from the input")
    sync()
    launches = dict(backend.LAUNCHES)
    if any(count == 0 for count in launches.values()):
        fail(f"a kernel was not launched on the main path: {launches}")
    results = {}
    x = backend.upload(payload, dev)
    for label, cand in (("fast", BC1_FAST_CANDIDATES),
                        ("comprehensive", BC1_COMPREHENSIVE_CANDIDATES)):
        ref = REFERENCE[label]
        pick = TransformHeader.from_bytes(outs[label]).bc1_settings()
        scores = [int(s) for s in auto.candidate_scores(x, LtuEstimation(), cand)]
        digest = hashlib.sha256(outs[label]).hexdigest()
        results[label] = {"pick": [int(pick.decorrelation_mode),
                                   pick.split_colour_endpoints],
                          "scores": scores, "sha256": digest}
        if scores != ref["scores"]:
            fail(f"{label}: scores {scores} != reference {ref['scores']}")
        if (int(pick.decorrelation_mode), pick.split_colour_endpoints) != ref["pick"]:
            fail(f"{label}: pick {pick} != reference {ref['pick']}")
        if digest != ref["sha256"]:
            fail(f"{label}: transformed file sha256 differs from the JAX package's")
    emit("main", t0, file_bytes=len(dds), payload_bytes=len(payload), blocks=BLOCKS,
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

    n = BLOCKS
    pick = Bc1TransformSettings()  # the pick of both candidate sets: variant 1, split
    v, sp = int(pick.decorrelation_mode), pick.split_colour_endpoints
    t = shuffle.bc1_transform(x, v, sp)
    keys = {label: tuple((int(c.decorrelation_mode), c.split_colour_endpoints)
                         for c in cand)
            for label, cand in (("fast", BC1_FAST_CANDIDATES),
                                ("comprehensive", BC1_COMPREHENSIVE_CANDIDATES))}
    rows = {label: regions.bc1_regions(x, key) for label, key in keys.items()}

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

    timed = {}
    timed["dlt_bc1_transform"] = dict(
        ms=event_ms(lambda: shuffle.bc1_transform(x, v, sp), 20),
        plain_ms=event_ms(lambda: shuffle.bc1_transform_plain(x, v, sp), 5),
        bytes=16 * n, ops=OPS_PAIR * n)
    timed["dlt_bc1_untransform"] = dict(
        ms=event_ms(lambda: shuffle.bc1_untransform(t, v, sp), 20),
        plain_ms=event_ms(lambda: shuffle.bc1_untransform_plain(t, v, sp), 5),
        bytes=16 * n, ops=OPS_PAIR * n)
    for label, key in keys.items():
        c = len(key)
        timed[f"dlt_bc1_regions/{label}"] = dict(
            ms=event_ms(lambda: regions.bc1_regions(x, key), 20),
            plain_ms=event_ms(lambda: regions.bc1_regions_plain(x, key), 5),
            bytes=8 * n + 4 * n * c, ops=3 * OPS_PAIR * n + 4 * c * n)
        r = rows[label]
        positions, compares = c * (4 * n - 3), compares_needed(r, 4 * n)
        timed[f"dlt_ltu_counts/{label}"] = dict(
            ms=event_ms(lambda: cuda_ltu.ltu_counts(r, 4 * n, ks, ws), 20),
            plain_ms=event_ms(lambda: cuda_ltu.ltu_counts_plain(r, 4 * n, ks, ws), 3),
            score_ms=event_ms(lambda: coverage_scores(r, 4 * n), 10),
            bytes=c * 4 * n, positions=positions, compares=compares,
            ops=OPS_GRAM * positions + OPS_COMPARE * compares,
            issue_ms=(SASS_PER_POSITION * positions + SASS_PER_COMPARE * compares)
            / int_rate * 1e3)
    for entry in timed.values():
        bytes_ms = entry["bytes"] / rate * 1e3
        ops_ms = entry["ops"] / int_rate * 1e3
        entry["bound_ms"] = max(bytes_ms, ops_ms)
        entry["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"

    # the host side of one transform and one untransform of the whole file
    dds_t = outs["fast"]
    copies = {}
    start = time.perf_counter()
    xt = backend.upload(payload, dev)
    copies["h2d_payload_s"] = time.perf_counter() - start
    start = time.perf_counter()
    backend.download(xt)
    copies["d2h_payload_s"] = time.perf_counter() - start
    start = time.perf_counter()
    handler.transform_bundle(dds, bundles["fast"])
    copies["transform_fast_file_s"] = time.perf_counter() - start
    start = time.perf_counter()
    handler.untransform(dds_t)
    copies["untransform_file_s"] = time.perf_counter() - start
    emit("times", t0, kernels=timed, host=copies,
         note="kernel ms: CUDA-event medians with L2 flushed before each launch")

    # ---- 6. the contract lines ----------------------------------------------------------
    kernels = []
    for name in REPLACES:
        entry = timed.get(name) or timed[f"{name}/comprehensive"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
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
