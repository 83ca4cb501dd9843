"""How the ``medium`` preset's BC7 search and zstd-1 identity guard split a corpus: the
LTU pick of each file, the setting it ships, and how many picks the guard checked and
reverted, by files and by payload bytes.

The corpus is the real-encoder BC7 corpus of ``CORPUS_REPORT.md`` (``utils.corpus.
build_bc7_dds_corpus``, as ``scripts/corpus_study.py`` builds it: textures encoded per
block by the least-error multi-mode encoder of ``utils.bc7codec``, full mip chains, DX10
containers). Every payload goes through the port's batch route,
``ModeSortBatchProcessor("bc7", max_batch=64)``, on the CPU. The configuration
``port_bench/configs/bc7-skyrim-mods.json`` splits its identity files into LTU picks and
guard reverts by this script's figures.

    python3 scripts/bc7_guard_study.py [--files 100]

Prints one JSON object. 100 files take about a minute to encode on one core.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DX10_PAYLOAD = 0x94  # 4-byte magic, 124-byte header, 20-byte DX10 extension


def _name(s) -> str:
    if not (s.sort_by_mode or s.split_byte_planes):
        return "identity"
    return "+".join(n for n, on in (("sort", s.sort_by_mode),
                                    ("planes", s.split_byte_planes)) if on)


def study(n_files: int) -> dict:
    from dxt_lossless_transform_tpu.utils.corpus import build_bc7_dds_corpus
    from dxt_lossless_transform_tpu_torch.parallel.pipeline import ModeSortBatchProcessor

    payloads = [dds[DX10_PAYLOAD:] for _, dds, _ in build_bc7_dds_corpus(n_files)]
    proc = ModeSortBatchProcessor("bc7", max_batch=64, device="cpu")
    results = proc.process(payloads)
    picked, shipped = Counter(), Counter()
    checked = reverted = checked_bytes = reverted_bytes = 0
    for i, r in enumerate(results):
        pick, ship = _name(proc.settings[proc.picks[i]]), _name(r.settings)
        picked[pick] += 1
        shipped[ship] += 1
        if pick != "identity":
            checked += 1
            checked_bytes += len(payloads[i])
            if ship != pick:
                reverted += 1
                reverted_bytes += len(payloads[i])
    total = sum(len(p) for p in payloads)
    return {"files": len(payloads), "payload_bytes": total,
            "ltu_picks": dict(picked), "shipped": dict(shipped),
            "guard_checked": checked, "guard_reverted": reverted,
            "guard_checked_bytes_pct": 100.0 * checked_bytes / total,
            "guard_reverted_bytes_pct": 100.0 * reverted_bytes / total}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=100)
    print(json.dumps(study(ap.parse_args().files), indent=1))


if __name__ == "__main__":
    main()
