"""Size-estimation protocol (counterpart of ``dxt_lossless_transform_tpu/estimate/base.py``).

Estimates are relative: the auto-search keeps the candidate with the smallest one.
The auto-search scores a (C, L) uint8 tensor of candidate regions with
:meth:`SizeEstimation.estimate_batch_device`. An estimator that scores on the device
(:class:`~.ltu.LtuEstimation`) overrides it and scores the rows where they lie; the
default copies the rows to the host and scores them there with
:meth:`SizeEstimation.estimate_batch`, as the JAX package's auto-search does for a
host-only estimator (its ``estimate_batch_device`` returns None).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


class SizeEstimation:
    """Base protocol for size estimators. A subclass defines :meth:`estimate` and
    may override the batch methods."""

    def max_compressed_size(self, len_bytes: int) -> int:
        """Upper bound on the size of a compressed buffer (for preallocation)."""
        raise NotImplementedError

    def estimate(self, data) -> int:
        """Estimate the compressed size of ``data`` (bytes). Lower is better."""
        raise NotImplementedError

    def estimate_batch(self, regions: Sequence) -> list:
        """Estimate several independent buffers: a loop over :meth:`estimate`."""
        return [self.estimate(r) for r in regions]

    def estimate_batch_device(self, regions: torch.Tensor,
                              valid_len: Union[int, torch.Tensor]) -> torch.Tensor:
        """Scores of the rows of a (C, L) uint8 tensor, of which the first
        ``valid_len`` bytes are real (one length, or a (C,) tensor of one per row),
        as a (C,) tensor on ``regions.device``: int64 when every score is an
        integer, else float64.

        This default copies each row's real bytes to the host and scores them with
        :meth:`estimate_batch`."""
        if isinstance(valid_len, torch.Tensor):
            lengths = [int(v) for v in valid_len.tolist()]
        else:
            lengths = [valid_len] * regions.shape[0]
        host = regions[:, :max(lengths, default=0)].cpu().numpy()
        scores = np.asarray(self.estimate_batch(
            [row[:v].tobytes() for row, v in zip(host, lengths)]))
        if scores.dtype.kind != "f" or np.array_equal(scores, np.round(scores)):
            scores = scores.astype(np.int64)
        return torch.from_numpy(scores).to(regions.device)


class NoEstimation(SizeEstimation):
    """Always 0: the estimator of the manual-settings paths."""

    def max_compressed_size(self, len_bytes: int) -> int:
        return 0

    def estimate(self, data, device="cuda") -> int:
        return 0

    def estimate_batch_device(self, regions: torch.Tensor,
                              valid_len: Union[int, torch.Tensor]) -> torch.Tensor:
        return torch.zeros(regions.shape[0], dtype=torch.int64, device=regions.device)
