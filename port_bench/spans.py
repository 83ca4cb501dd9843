#!/usr/bin/env python3
"""The program's own spans and counters in a traced window, reduced to records.

The port opens ``dlt.*`` spans (``utils/profiling.span``: each batch processor's
call ``dlt.<prefix>.process`` and its stages ``dlt.<prefix>.<stage>``, the wait on
the card ``dlt.backend.wait``) and keeps counters (``backend.counters()``). From a
traced window's events (:mod:`.trace`) and the counters just before and after it,
:func:`reduce` gives:

- ``span_self_s``: each span name's self seconds in the window, its spans' durations
  less those of the ``dlt.*`` spans directly inside them (nesting by time: the
  program's spans are opened by one thread);
- ``counters``: the counters' change over the window.

:func:`quantities` reads per-MB and per-GB figures from them against the window's
payload bytes. The card's idle time by stage is the run's own
``breakdown.idle_gaps``, which names the innermost host event, ``dlt.*`` spans
included, over each gap. Run as a script,

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s>

makes one traced run of a cell as ``run.py --trace 1`` does, with these records
taken around its window, and prints one JSON line: the run's window, metrics and
breakdown, the records and the quantities. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import trace  # noqa: E402

PROGRAM = "dlt."


def self_seconds(events: List[trace.Event]) -> dict:
    """{span name: seconds in its spans less those of ``dlt.*`` spans directly
    inside them} over the window, each span cut at its end."""
    win = [e for e in events if e.kind == "window"]
    if not win:
        raise ValueError("no window span in the trace")
    ws, we = win[0].start, win[0].end
    # outermost first where two start together
    spans = sorted((trace.Event(e.name, e.kind, e.start, min(e.end, we))
                    for e in events if e.kind == "host"
                    and e.name.startswith(PROGRAM) and ws <= e.start < we),
                   key=lambda e: (e.start, -e.end))
    out = defaultdict(float)
    stack = []
    for s in spans:
        while stack and stack[-1].end < s.end:
            stack.pop()
        d = (s.end - s.start) / 1e9
        out[s.name] += d
        if stack:
            out[stack[-1].name] -= d
        stack.append(s)
    return dict(out)


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def reduce(events: List[trace.Event], before: dict, after: dict) -> dict:
    return {"span_self_s": self_seconds(events),
            "counters": counter_delta(before, after)}


def quantities(records: dict) -> dict:
    """Per-MB (10^6 bytes) and per-GB figures of the window's payload bytes: self ms
    of the batch pipeline's serialize and assemble stages and of the wait on the
    card, the share of launched blocks that are payload and the pinned pool's
    growths. A figure whose inputs are missing is None."""
    nbytes = records.get("bytes") or 0
    self_s = records.get("span_self_s") or {}
    counts = records.get("counters") or {}

    def ms_per_mb(name):
        if not nbytes or name not in self_s:
            return None
        return 1000.0 * self_s[name] / (nbytes / 1e6)
    launched = counts.get("batch.blocks_launched")
    growths = counts.get("pinned_pool_growths")
    return {
        "build_serialize_ms_per_MB": ms_per_mb("dlt.batch.serialize"),
        "build_assemble_ms_per_MB": ms_per_mb("dlt.batch.assemble"),
        "build_wait_ms_per_MB": ms_per_mb("dlt.backend.wait"),
        "build_useful_blocks": (100.0 * counts["batch.blocks_real"] / launched
                                if launched else None),
        "build_pinned_growths_per_GB": (growths / (nbytes / 1e9)
                                        if nbytes and growths is not None else None),
    }


def traced_run(spec: dict, seed: int, seconds: float, device) -> tuple:
    """One traced run of a resolved cell through ``run.run_cell``, with this module's
    records taken around its window; -> (the run's result, the records)."""
    from dxt_lossless_transform_tpu_torch import backend
    from port_bench import run

    held = {}
    plain = trace.profile

    def profile(fn, dev):
        before = backend.counters()
        out, events = plain(fn, dev)
        held.update(reduce(events, before, backend.counters()))
        return out, events

    trace.profile = profile
    try:
        res = run.run_cell(spec, seed, seconds, True, device)
    finally:
        trace.profile = plain
    return res, dict(held, bytes=res["records"]["bytes"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    from port_bench import run
    import torch

    spec = run.resolve(run.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("port_bench.spans: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res, records = traced_run(spec, args.seed, args.seconds, device)
    rec = res["records"]
    print(json.dumps({
        "card": run.card_line(), "workload": args.workload, "seed": args.seed,
        "correct": res["correct"], "window": res["window"], "metrics": res["metrics"],
        "busy_s": rec["busy_s"], "window_s": rec["window_s"],
        "breakdown": {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]},
        "records": records, "quantities": quantities(records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
