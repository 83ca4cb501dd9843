"""Size-estimation protocol (counterpart of ``dxt_lossless_transform_tpu/estimate/base.py``).

Estimates are relative: the auto-search keeps the candidate with the smallest one.
The auto-search scores a (C, L) uint8 tensor of candidate regions with
:meth:`SizeEstimation.estimate_batch_device`, on the device the tensor lies on, so
that the whole search stays there. Host-only estimators (zstd) come with a later
slice of the port.
"""

from __future__ import annotations

import torch


class SizeEstimation:
    """Base protocol for size estimators."""

    def estimate(self, data, device="cuda") -> int:
        """Estimate the compressed size of ``data`` (bytes), computed on ``device``.
        Lower is better."""
        raise NotImplementedError

    def estimate_batch_device(self, regions: torch.Tensor,
                              valid_len: int) -> torch.Tensor:
        """Scores of the rows of a (C, L) uint8 tensor, of which the first
        ``valid_len`` bytes are real, as a (C,) tensor on ``regions.device``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not score on the device")


class NoEstimation(SizeEstimation):
    """Always 0: the estimator of the manual-settings paths."""

    def estimate(self, data, device="cuda") -> int:
        return 0

    def estimate_batch_device(self, regions: torch.Tensor,
                              valid_len: int) -> torch.Tensor:
        return torch.zeros(regions.shape[0], dtype=torch.int64, device=regions.device)
