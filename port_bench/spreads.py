#!/usr/bin/env python3
"""Spreads and bounds from the runs that ``sets.sh`` leaves in a directory.

    python3 port_bench/spreads.py DIR

Reads ``DIR/<workload>.<set><i>.out`` (the last line of each is a run's result; the
sets are ``A`` and ``B``, six runs each, the same seeds in both) and prints, per
cell and metric, each set's median and spread (quartile distance over the median,
``statistics.quantiles``), the wider spread, five times it as the bound it would
give, and the tightness reading (the mean of the two sets' spreads, each without its
run farthest from the median), which has to stay under half the bound; ``setup_s``
leaves out a run that built the kernel library (``setup.library_built``). Then,
over the cells, the widest spread per metric and its bound.
"""

import json
import re
import statistics
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import stats  # noqa: E402

NAME = re.compile(r"^(?P<cell>.+)\.(?P<set>[AB])(?P<i>\d+)\.out$")


def main(argv=None) -> int:
    d = Path((argv or sys.argv[1:])[0])
    runs = defaultdict(lambda: defaultdict(list))  # (cell, metric) -> set -> values
    correct = defaultdict(list)
    for p in sorted(d.glob("*.out")):
        m = NAME.match(p.name)
        if not m:
            continue
        lines = p.read_text().strip().splitlines()
        if not lines:
            continue
        res = json.loads(lines[-1])
        correct[m["cell"]].append(res["correct"])
        for name, v in res["metrics"].items():
            if name == "setup_s" and res.get("setup", {}).get("library_built"):
                continue
            runs[(m["cell"], name)][m["set"]].append(v["value"])
    widest = defaultdict(float)
    for (cell, name), sets in sorted(runs.items()):
        row = {"cell": cell, "metric": name, "correct": all(correct[cell])}
        spreads = []
        for s, values in sorted(sets.items()):
            row[s] = {"n": len(values), "median": statistics.median(values),
                      "spread": stats.spread(values) if len(values) >= 2 else None,
                      "spread_wo_farthest": (stats.spread_without_farthest(values)
                                             if len(values) >= 3 else None)}
            if row[s]["spread"] is not None:
                spreads.append(row[s]["spread"])
        if spreads:
            row["wider"] = max(spreads)
            row["bound"] = stats.bound(max(spreads))
            tight = [row[s]["spread_wo_farthest"] for s in sorted(sets)
                     if row[s]["spread_wo_farthest"] is not None]
            if tight:
                row["tightness"] = sum(tight) / len(tight)
            widest[name] = max(widest[name], max(spreads))
        print(json.dumps(row))
    for name, w in sorted(widest.items()):
        print(json.dumps({"metric": name, "widest_spread": w, "bound": stats.bound(w)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
