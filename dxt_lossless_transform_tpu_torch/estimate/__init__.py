"""Pluggable compressed-size estimation.

Counterpart of ``dxt_lossless_transform_tpu/estimate``, with the same names at the
package level: only the relative order of the candidates' estimates matters.

- :class:`NoEstimation`   -- 0 for everything (the manual-settings paths).
- :class:`ZstdEstimation` -- zstd through the system ``libzstd.so.1`` on the host,
  loaded by the first estimate, not by this import.
- :class:`LtuEstimation`  -- the LZ-match count on the device (the count kernel).
"""

from .base import SizeEstimation, NoEstimation  # noqa: F401
from .zstd import ZstdEstimation  # noqa: F401
from .ltu import LtuEstimation  # noqa: F401
