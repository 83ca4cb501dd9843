"""Reference constants for the PyTorch port's chip smoke run (``chip_smoke.py``).

Builds the smoke run's BC1 and BC3 DDS files (4096x4096, full 13-level mip chain,
seed below) with the JAX package's ``utils.testgen.make_dds`` and prints, for each
format and for the FAST and the COMPREHENSIVE candidates: the exact integer LTU
score of each candidate (the numpy twin ``estimate.ltu._coverage_score_np``; for
BC1 on each candidate's colour region, for BC3 the sum over its alpha-endpoint
region and its colour region, as ``ops/auto.py:transform_bc3_auto`` scores them),
the pick (first minimum), and the sha256 of the file that the JAX package's
``DdsHandler`` writes with that pick through its manual builder. Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dxt_lossless_transform_tpu.api import (  # noqa: E402
    Bc1ManualTransformBuilder, Bc3ManualTransformBuilder,
)
from dxt_lossless_transform_tpu.estimate.ltu import (  # noqa: E402
    DEFAULT_OFFSETS, _coverage_score_np,
)
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle  # noqa: E402
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler  # noqa: E402
from dxt_lossless_transform_tpu.ops.auto import _host_colour_regions  # noqa: E402
from dxt_lossless_transform_tpu.settings import (  # noqa: E402
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES, BC3_COMPREHENSIVE_CANDIDATES,
    BC3_FAST_CANDIDATES,
)
from dxt_lossless_transform_tpu.utils.testgen import make_dds  # noqa: E402

SIZE, MIPS, SEED = 4096, 13, 7


def _score(row: bytes) -> int:
    return int(_coverage_score_np(np.frombuffer(row, np.uint8), DEFAULT_OFFSETS))


def _pick(dds: bytes, cand, scores, bundle) -> dict:
    best = cand[int(np.argmin(scores))]
    out = DdsHandler().transform_bundle(dds, bundle(best))
    return {"scores": scores,
            "pick": [int(best.decorrelation_mode)]
            + ([best.split_alpha_endpoints] if hasattr(best, "split_alpha_endpoints")
               else []) + [best.split_colour_endpoints],
            "sha256": hashlib.sha256(out).hexdigest()}


def bc1() -> dict:
    dds = make_dds("BC1", SIZE, SIZE, MIPS, seed=SEED)
    payload = dds[0x80:]
    colours = np.frombuffer(payload, "<u4").reshape(-1, 2)[:, 0].copy()
    result = {"blocks": len(payload) // 8, "payload_bytes": len(payload),
              "file_sha256": hashlib.sha256(dds).hexdigest()}
    for name, cand in (("fast", BC1_FAST_CANDIDATES),
                       ("comprehensive", BC1_COMPREHENSIVE_CANDIDATES)):
        key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)
        scores = [_score(r) for r in _host_colour_regions(colours, key)]
        result[name] = _pick(dds, cand, scores, lambda best: TransformBundle(
            bc1=Bc1ManualTransformBuilder(best)))
    return result


def bc3() -> dict:
    dds = make_dds("BC3", SIZE, SIZE, MIPS, seed=SEED)
    payload = dds[0x80:]
    words = np.frombuffer(payload, "<u4").reshape(-1, 4)
    colours = words[:, 2].copy()
    ep = (words[:, 0] & 0xFFFF).astype(np.int64)
    # the alpha rows of ops/auto.py:transform_bc3_auto's host path
    alpha = {False: ep.astype("<u2").tobytes(),
             True: (ep & 0xFF).astype(np.uint8).tobytes()
             + (ep >> 8).astype(np.uint8).tobytes()}
    alpha_scores = {sa: _score(row) for sa, row in alpha.items()}
    colour_scores = {}
    result = {"blocks": len(payload) // 16, "payload_bytes": len(payload),
              "file_sha256": hashlib.sha256(dds).hexdigest()}
    for name, cand in (("fast", BC3_FAST_CANDIDATES),
                       ("comprehensive", BC3_COMPREHENSIVE_CANDIDATES)):
        key = [(int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand]
        todo = [k for k in dict.fromkeys(key) if k not in colour_scores]
        for k, row in zip(todo, _host_colour_regions(colours, todo)):
            colour_scores[k] = _score(row)
        scores = [alpha_scores[c.split_alpha_endpoints] + colour_scores[k]
                  for c, k in zip(cand, key)]
        result[name] = _pick(dds, cand, scores, lambda best: TransformBundle(
            bc3=Bc3ManualTransformBuilder(best)))
    return result


def main() -> None:
    print(json.dumps({"bc1": bc1(), "bc3": bc3()}))


if __name__ == "__main__":
    main()
