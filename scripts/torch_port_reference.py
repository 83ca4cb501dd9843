"""Reference constants for the PyTorch port's chip smoke run (``chip_smoke.py``).

Builds the smoke run's BC1 DDS file (4096x4096, full 13-level mip chain, seed
below) with the JAX package's ``utils.testgen.make_dds`` and prints, for the FAST and
the COMPREHENSIVE candidates: the exact integer LTU score of each candidate (the
numpy twin ``estimate.ltu._coverage_score_np`` on each candidate's colour region),
the pick (first minimum), and the sha256 of the file that the JAX package's
``DdsHandler`` writes with that pick. Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dxt_lossless_transform_tpu.api import Bc1ManualTransformBuilder  # noqa: E402
from dxt_lossless_transform_tpu.estimate.ltu import (  # noqa: E402
    DEFAULT_OFFSETS, _coverage_score_np,
)
from dxt_lossless_transform_tpu.formats.bundle import TransformBundle  # noqa: E402
from dxt_lossless_transform_tpu.formats.handlers import DdsHandler  # noqa: E402
from dxt_lossless_transform_tpu.ops.auto import _host_colour_regions  # noqa: E402
from dxt_lossless_transform_tpu.settings import (  # noqa: E402
    BC1_COMPREHENSIVE_CANDIDATES, BC1_FAST_CANDIDATES,
)
from dxt_lossless_transform_tpu.utils.testgen import make_dds  # noqa: E402

SIZE, MIPS, SEED = 4096, 13, 7


def main() -> None:
    dds = make_dds("BC1", SIZE, SIZE, MIPS, seed=SEED)
    payload = dds[0x80:]
    colours = np.frombuffer(payload, "<u4").reshape(-1, 2)[:, 0].copy()
    result = {"blocks": len(payload) // 8, "payload_bytes": len(payload),
              "file_sha256": hashlib.sha256(dds).hexdigest()}
    for name, cand in (("fast", BC1_FAST_CANDIDATES),
                       ("comprehensive", BC1_COMPREHENSIVE_CANDIDATES)):
        key = tuple((int(c.decorrelation_mode), c.split_colour_endpoints) for c in cand)
        rows = _host_colour_regions(colours, key)
        scores = [int(_coverage_score_np(np.frombuffer(r, np.uint8), DEFAULT_OFFSETS))
                  for r in rows]
        best = cand[int(np.argmin(scores))]
        out = DdsHandler().transform_bundle(
            dds, TransformBundle(bc1=Bc1ManualTransformBuilder(best)))
        result[name] = {"scores": scores,
                        "pick": [int(best.decorrelation_mode),
                                 best.split_colour_endpoints],
                        "sha256": hashlib.sha256(out).hexdigest()}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
