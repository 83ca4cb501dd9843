#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's and the controls', seed by seed,
in one process on the card.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--controls skip_search]

For each seed, one run of the program (what a benchmark run compares), then one run
of each control: the plain reference put in the program's place, with one of the
configuration's guarantees broken (the entry's ``CONTROLS``; all of them by
default). Each run prints one JSON line with its ``checks``; a sound limit passes
every program run and fails every run of at least one control. The benchmark's own
runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--controls", default=None, help="comma-separated; default all")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = run.resolve(run.load_json(run.ROOT / "BENCHMARK.json"), args.workload)
    entry = run.load_module(run.bench_dir(run.ROOT) / "entries" / f"{spec['mix']['entry']}.py",
                            "port_bench_control_entry")
    controls = args.controls.split(",") if args.controls else list(entry.CONTROLS)
    print(json.dumps({"card": run.card_line(), "workload": args.workload}), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in [None] + controls:
            t0 = time.perf_counter()
            res = run.run_cell(spec, seed, args.seconds, False, device, control=mode, t0=t0)
            print(json.dumps({"seed": seed, "mode": mode or "program",
                              "correct": res["correct"], "checks": res["checks"],
                              "window": res["window"], "errors": res["errors"][:1],
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
