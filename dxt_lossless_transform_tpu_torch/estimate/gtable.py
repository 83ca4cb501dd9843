"""Integer entropy table G[n] = floor(n * log2(n) + 0.5) for n <= 65536.

The same numpy formula as ``dxt_lossless_transform_tpu/estimate/gtable.py:17-24``;
the tests hold the two tables equal.
"""

from __future__ import annotations

import numpy as np

ENTROPY_CAP = 65536


def _make_g_table() -> np.ndarray:
    g = np.zeros(ENTROPY_CAP + 1, np.int64)
    n = np.arange(2, ENTROPY_CAP + 1, dtype=np.float64)
    g[2:] = np.floor(n * np.log2(n) + 0.5).astype(np.int64)
    return g


G_TABLE = _make_g_table()
