"""Size-estimation protocol (counterpart of ``dxt_lossless_transform_tpu/estimate/base.py``).

Estimates are relative: the auto-search keeps the candidate with the smallest one.
The auto-search scores a (C, L) uint8 tensor of candidate regions with
:meth:`SizeEstimation.estimate_batch_device`, or several such parts of one search
with :meth:`SizeEstimation.estimate_parts_device`. An estimator that scores on the
device (:class:`~.ltu.LtuEstimation`) overrides the first and scores the rows where
they lie, one call a part; the default copies the rows to the host once and scores
them there with :meth:`SizeEstimation.estimate_batch`, in one call for all parts, as
the JAX package's auto-search does for a host-only estimator (its
``estimate_batch_device`` returns None).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from .. import backend

ValidLen = Union[int, torch.Tensor]


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
                              valid_len: ValidLen) -> torch.Tensor:
        """Scores of the rows of a (C, L) uint8 tensor, of which the first
        ``valid_len`` bytes are real (one length, or a (C,) tensor of one per row),
        as a (C,) tensor on ``regions.device``: int64 when every score is an
        integer, else float64.

        This default scores the rows on the host (:meth:`estimate_parts_device`)."""
        return self._host_scores([(regions, valid_len)])[0]

    def estimate_parts_device(self, parts: Sequence[Tuple[torch.Tensor, ValidLen]]
                              ) -> List[torch.Tensor]:
        """:meth:`estimate_batch_device` of each ``(regions, valid_len)`` part. An
        estimator that overrides :meth:`estimate_batch_device` scores the parts one
        by one with it; the default copies every part's rows to the host at once
        and scores all their rows in one :meth:`estimate_batch` call."""
        if type(self).estimate_batch_device is not SizeEstimation.estimate_batch_device:
            return [self.estimate_batch_device(rows, v) for rows, v in parts]
        return self._host_scores(parts)

    def _host_scores(self, parts) -> List[torch.Tensor]:
        """Each row's real bytes handed to :meth:`estimate_batch` as a numpy view:
        of the rows themselves on the CPU, else of one pinned host buffer into which
        every part's rows were copied, with one synchronisation. The parts lie on one
        device."""
        lengths = [[int(x) for x in v.tolist()] if isinstance(v, torch.Tensor)
                   else [int(v)] * rows.shape[0] for rows, v in parts]
        device = parts[0][0].device if parts else torch.device("cpu")
        hosts = [rows for rows, _ in parts]
        if device.type == "cuda":
            widths = [max(ls, default=0) for ls in lengths]
            staged = backend.host_buffer(
                (sum(rows.shape[0] * w for rows, w in zip(hosts, widths)),),
                torch.uint8, device)
            pos = 0
            for j, (rows, w) in enumerate(zip(hosts, widths)):
                hosts[j] = staged[pos:pos + rows.shape[0] * w].view(rows.shape[0], w)
                hosts[j].copy_(rows[:, :w], non_blocking=True)
                pos += hosts[j].numel()
            torch.cuda.current_stream(device).synchronize()
        scores = np.asarray(self.estimate_batch(
            [host.numpy()[r, :v] for host, ls in zip(hosts, lengths)
             for r, v in enumerate(ls)]))
        out, pos = [], 0
        for ls in lengths:
            part = scores[pos:pos + len(ls)]
            pos += len(ls)
            if part.dtype.kind != "f" or np.array_equal(part, np.round(part)):
                part = part.astype(np.int64)
            out.append(torch.from_numpy(part).to(device))
        return out


class NoEstimation(SizeEstimation):
    """Always 0: the estimator of the manual-settings paths."""

    def max_compressed_size(self, len_bytes: int) -> int:
        return 0

    def estimate(self, data, device="cuda") -> int:
        return 0

    def estimate_batch_device(self, regions: torch.Tensor,
                              valid_len: ValidLen) -> torch.Tensor:
        return torch.zeros(regions.shape[0], dtype=torch.int64, device=regions.device)
