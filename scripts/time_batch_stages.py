#!/usr/bin/env python3
"""Time each host and device stage of the BC1-BC5 batch pipeline, on one card, for a
checkout given by its directory, in a fresh process, so that two versions of the
pipeline can be compared in turns within one call (parent, change, change, parent).

    python3 scripts/time_batch_stages.py [--root DIR] [--repeats N]

``--root`` is the directory that holds the ``dxt_lossless_transform_tpu_torch``
package to time (default: this checkout). The payloads are ``chip_smoke.py``'s batch
corpus of each format (31 chains of 64x64 to 4096x4096 blocks and one empty payload,
``chip_smoke.batch_corpus``, imported from this checkout). Each format runs once to
build and warm the kernels, then N times through ``BatchProcessor(timing=True)``
(FAST candidates, LTU scores on the card) and N times through
``UntransformBatchProcessor(timing=True)`` on the results; ``timing`` synchronises
the card around each stage (``assemble``, ``h2d``, ``device``, ``d2h``,
``serialize``), so that each stage's seconds are its own. Prints the ``nvidia-smi``
line and one JSON object: for each format and direction, each stage's median
seconds over the N runs, and every run's readings.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# chip_smoke.py's corpus comes from this checkout; the package timed stays the one
# under ``--root``, first on the path
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_batch_stages: no CUDA device")
    import chip_smoke
    from dxt_lossless_transform_tpu_torch import parallel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip()
    out = {"root": args.root, "package": parallel.__file__, "formats": {}}
    for fmt in chip_smoke.BATCH_FORMATS:
        data = chip_smoke.batch_corpus(fmt)
        entries = [(r.transformed, r.settings) for r in parallel.BatchProcessor(
            fmt, max_batch=chip_smoke.BATCH_MAX).process(data)]
        parallel.UntransformBatchProcessor(fmt, max_batch=chip_smoke.BATCH_MAX).process(
            entries)
        runs = {"transform": [], "untransform": []}
        for _ in range(args.repeats):
            proc = parallel.BatchProcessor(fmt, max_batch=chip_smoke.BATCH_MAX, timing=True)
            if [(r.transformed, r.settings) for r in proc.process(data)] != entries:
                raise SystemExit(f"time_batch_stages: {fmt} batches differ between runs")
            runs["transform"].append(proc.times.seconds)
            back = parallel.UntransformBatchProcessor(fmt, max_batch=chip_smoke.BATCH_MAX,
                                                      timing=True)
            if back.process(entries) != data:
                raise SystemExit(f"time_batch_stages: {fmt} did not come back")
            runs["untransform"].append(back.times.seconds)
        out["formats"][fmt] = {
            way: {"median_s": {stage: statistics.median(r[stage] for r in readings)
                               for stage in readings[0]},
                  "runs": readings}
            for way, readings in runs.items()}
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
