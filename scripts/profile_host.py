#!/usr/bin/env python3
"""Where the host time of one DDS transform and untransform goes, on one card.

    python3 scripts/profile_host.py [--format BC3] [--repeats 5]

Drives the 4096x4096 file of ``chip_smoke.py`` (full mip chain, seed 7) through
``DdsHandler`` with the FAST auto-search, then repeats the same steps one by one
in the order the handler takes them, synchronising after each, and prints the
median seconds of each step beside the median of the whole call. Last, it
profiles the whole calls with ``cProfile`` and prints the functions that hold the
most time of their own. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--format", default="BC3", choices=("BC1", "BC3"))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_host: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from dxt_lossless_transform_tpu_torch import backend
    from dxt_lossless_transform_tpu_torch.api import (
        Bc1AutoTransformBuilder, Bc3AutoTransformBuilder,
    )
    from dxt_lossless_transform_tpu_torch.estimate.ltu import LtuEstimation
    from dxt_lossless_transform_tpu_torch.formats.bundle import TransformBundle
    from dxt_lossless_transform_tpu_torch.formats.dds import parse_dds
    from dxt_lossless_transform_tpu_torch.formats.embed import TransformHeader
    from dxt_lossless_transform_tpu_torch.formats.handlers import DdsHandler
    from dxt_lossless_transform_tpu_torch.ops import auto, bc1, bc3
    from dxt_lossless_transform_tpu_torch.settings import (
        BC1_FAST_CANDIDATES, BC3_FAST_CANDIDATES,
    )
    from dxt_lossless_transform_tpu_torch.utils.testgen import make_dds

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    bc3_fmt = args.format == "BC3"
    ops = bc3 if bc3_fmt else bc1
    search = auto.bc3_candidate_scores if bc3_fmt else auto.candidate_scores
    cand = BC3_FAST_CANDIDATES if bc3_fmt else BC1_FAST_CANDIDATES
    builder = (Bc3AutoTransformBuilder if bc3_fmt else Bc1AutoTransformBuilder)(
        LtuEstimation())
    bundle = TransformBundle(**{args.format.lower(): builder})
    header_of = TransformHeader.for_bc3 if bc3_fmt else TransformHeader.for_bc1
    handler = DdsHandler()
    dds = make_dds(args.format, 4096, 4096, 13, seed=7)
    out = handler.transform_bundle(dds, bundle)

    steps = {}

    def step(name, fn):
        start = time.perf_counter()
        value = fn()
        sync()
        steps.setdefault(name, []).append(time.perf_counter() - start)
        return value

    for _ in range(args.repeats):
        step("transform_bundle", lambda: handler.transform_bundle(dds, bundle))
        step("untransform", lambda: handler.untransform(out))
        info = step("parse", lambda: parse_dds(dds))
        start, end = info.data_offset, info.data_offset + info.data_length
        payload = step("slice", lambda: dds[start:end])
        x = step("upload", lambda: backend.upload(payload, dev))
        scores = step("search", lambda: search(x, LtuEstimation(), cand))
        best = cand[int(scores.argmin())]
        t = step("transform_tensor", lambda: ops.transform_tensor(x, best))
        body = step("download", lambda: backend.download(t))
        step("assemble", lambda: header_of(best).to_bytes() + dds[4:start] + body
             + dds[end:])
        step("untransform_bytes", lambda: ops.untransform(body, best, dev))
    medians = {name: statistics.median(v) for name, v in steps.items()}

    profile = cProfile.Profile()
    profile.enable()
    for _ in range(args.repeats):
        handler.transform_bundle(dds, bundle)
        handler.untransform(out)
    profile.disable()
    text = io.StringIO()
    pstats.Stats(profile, stream=text).sort_stats("tottime").print_stats(15)
    print(text.getvalue())
    print(json.dumps({"format": args.format, "repeats": args.repeats,
                      "device": torch.cuda.get_device_name(0), "median_s": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
