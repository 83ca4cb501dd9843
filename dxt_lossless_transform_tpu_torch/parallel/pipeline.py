"""Corpus batch pipeline: many textures per device step, on one device or a mesh.

Counterpart of ``dxt_lossless_transform_tpu/parallel/pipeline.py``. Payloads of one
format are grouped by padded block-count bucket (:func:`..ops.lanes.bucket_size`),
stacked into (files x words) batches, auto-searched and transformed with one launch
of each kernel per batch (:mod:`.sharded`), and returned in submission order as
:class:`BatchResult`. The results equal the port's per-file auto-search on the same
payload and estimator, in settings and bytes, and the JAX package's batch pipeline.

- :class:`BatchProcessor` (BC1-BC5): one step (:class:`.sharded.BatchStep`) for
  every estimator: the device builds every candidate's region row, the estimator
  scores them (LTU on the device, the CLI's ``medium`` preset, the JAX scorer's exact
  integer twin; ``ZstdEstimation(1)`` on the host, the ``optimal``/``max`` presets),
  the device writes each file's final transformed bytes under its winner, and the
  host copies each file's slice out. The host's two copies of a batch, the payloads
  into their pinned rows and the rows out into each file's ``bytes``, are one call
  each of the parallel copier (:mod:`.host_copy`).
- :class:`ModeSortBatchProcessor` (BC7/BC6H) and :class:`RgbBatchProcessor`: every
  file's candidate streams scored in one count call per batch.
- :class:`UntransformBatchProcessor`, the batched load path: BC1-BC5 files grouped
  by (settings, bucket), each file's streams laid out bucket-padded side by side,
  and the whole batch inverted by one launch of the format's untransform kernel;
  BC7/BC6H and RGB payloads go through the per-file untransform.

In the BC1-BC5 processor and in the load path, the next batch's upload and kernels
are queued before the host serializes (or scores) the current one, whose results come
back through pinned buffers (:class:`..backend.Download`). The device is CUDA unless
the caller passes ``device="cpu"``, which runs the kernels' plain versions. With a
``mesh`` (:func:`.mesh.make_mesh`) the BC1-BC5 processor runs the sharded step on
the mesh's devices (its ``device`` argument gives way to them): a batch is padded to
a multiple of the files axis by repeating its last file, as in JAX, and the results
are the same.

Left out: the TPU tile-grid padding of a batch (``_pad_batch_for_tiles``; there is no
tile grid, the kernels take any shape) and the routing of small payloads to a native
host runtime or the per-file search (``DLT_DEVICE_MIN_BYTES``,
``DLT_MEDIUM_BATCH_NATIVE``, the host pool of the load path: every payload is
batched, which gives the same bytes).
"""

from __future__ import annotations

import os
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import backend
from ..estimate.ltu import DEFAULT_OFFSETS, LtuEstimation
from ..ops import bc45 as ops_bc45, bc6h as ops_bc6h, bc7 as ops_bc7
from ..ops import hostwrap, lanes, rgb as ops_rgb
from ..ops.auto import distinct
from ..ops.cuda import channels, shuffle
from ..utils.profiling import span
from ..settings import (
    BC1_FAST_CANDIDATES, BC2_FAST_CANDIDATES, BC3_FAST_CANDIDATES,
    BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, RGB_FAST_CANDIDATES,
    Bc4TransformSettings, Bc5TransformSettings,
)
from . import host_copy, mesh as mesh_lib, sharded


@dataclass
class BatchResult:
    """One file's outcome, in submission order."""

    index: int
    transformed: bytes
    settings: object


# block_size, words per block, the default candidates and the step's candidate key
_FORMATS = {
    "bc1": dict(block_size=8, words=2, candidates=BC1_FAST_CANDIDATES,
                key=lambda c: (int(c.decorrelation_mode), c.split_colour_endpoints)),
    "bc2": dict(block_size=16, words=4, candidates=BC2_FAST_CANDIDATES,
                key=lambda c: (int(c.decorrelation_mode), c.split_colour_endpoints)),
    "bc3": dict(block_size=16, words=4, candidates=BC3_FAST_CANDIDATES,
                key=lambda c: (int(c.decorrelation_mode), c.split_alpha_endpoints,
                               c.split_colour_endpoints)),
    "bc4": dict(block_size=8, words=2,
                candidates=tuple(Bc4TransformSettings.all_combinations()),
                key=lambda c: (c.split_endpoints,)),
    "bc5": dict(block_size=16, words=4,
                candidates=tuple(Bc5TransformSettings.all_combinations()),
                key=lambda c: (c.split_endpoints,)),
}


class StageTimes:
    """The stages of a processor's batches: each is the span ``dlt.<prefix>.<stage>``
    (:func:`..utils.profiling.span`) inside the call's span ``dlt.<prefix>.process``
    (:meth:`call`), and its seconds are kept only when ``enabled``: then the device
    is synchronised around each stage, which stops the batches from overlapping, so
    that each stage's time is its own."""

    def __init__(self, device: torch.device, enabled: bool, prefix: str):
        self.device, self.enabled, self.prefix = device, enabled, prefix
        self.seconds: dict = {}
        #: calls begun, the sequence number in each call's span
        self.calls = 0

    def call(self, files: int):
        """The span of one call of ``files`` payloads."""
        self.calls += 1
        return span(f"dlt.{self.prefix}.process", f"call={self.calls} files={files}")

    @contextmanager
    def __call__(self, stage: str):
        with span(f"dlt.{self.prefix}.{stage}"):
            if not self.enabled:
                yield
                return
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            start = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                   + time.perf_counter() - start)


class BatchProcessor:
    """Pack payloads of one texture format into bucket-sized batches and
    auto-transform them on the device.

    The ``estimator`` (LTU with the default offsets when None) scores every
    candidate's region row: on the device, or on the host for a host estimator such
    as ``ZstdEstimation(1)``, one batch behind the device. With a ``mesh`` the step
    runs sharded over it, each batch uploaded to ``mesh.home``. ``timing`` keeps each
    stage's seconds in :attr:`times` (and serializes the batches)."""

    def __init__(self, fmt: str, mesh=None, candidates=None, max_batch: int = 64,
                 estimator=None, device: Union[str, torch.device] = "cuda",
                 timing: bool = False):
        cfg = _FORMATS[fmt]
        self.cfg = cfg
        self.fmt = fmt
        self.mesh = None if mesh is None else mesh_lib.require(mesh)
        self.candidates = tuple(candidates if candidates is not None
                                else cfg["candidates"])
        self._cand_key = tuple(cfg["key"](c) for c in self.candidates)
        self.max_batch = max_batch
        self.estimator = LtuEstimation(DEFAULT_OFFSETS) if estimator is None else estimator
        self.device = mesh.home if mesh is not None else backend.resolve_device(device)
        self._step = sharded.BatchStep(fmt, self._cand_key, self.estimator, self.mesh)
        self.times = StageTimes(self.device, timing, "batch")
        #: device batches run by the last :meth:`process`
        self.batches = 0

    def _prepare_batches(self, payloads: Sequence[bytes], order):
        """Bucket payloads into (chunk, host flats, valid lengths) batches: the host
        copier lays each payload into its row and zeroes the row's tail, in one call
        a batch. Under a mesh a batch is padded to a multiple of the files axis with
        copies of its last file. Counts each batch's real and launched blocks."""
        bs, wpb = self.cfg["block_size"], self.cfg["words"]
        files = 1 if self.mesh is None else self.mesh.shape["files"]
        by_bucket: dict = {}
        for i, data in enumerate(payloads):
            if len(data) % bs:
                raise ValueError(f"payload {i}: length {len(data)} not divisible by {bs}")
            n = len(data) // bs
            if n == 0:
                order[i] = BatchResult(i, b"", self.candidates[-1])
                continue
            by_bucket.setdefault(lanes.bucket_size(n), []).append(i)

        for bucket, indices in sorted(by_bucket.items()):
            for start in range(0, len(indices), self.max_batch):
                chunk = indices[start:start + self.max_batch]
                padded = -(-len(chunk) // files) * files
                laid = chunk + chunk[-1:] * (padded - len(chunk))  # each row's file
                with self.times("assemble"):
                    flats = backend.host_buffer((padded, wpb * bucket), torch.int32,
                                                self.device)
                    # the payloads' bytes as they are: the card reads them as
                    # little-endian words, so nothing is reinterpreted on the host
                    host = flats.numpy().view(np.uint8)
                    host_copy.copy([(host[row], payloads[idx], len(payloads[idx]),
                                     host.shape[1]) for row, idx in enumerate(laid)])
                    valid = [4 * (len(payloads[idx]) // bs) for idx in laid]
                backend.count("batch.blocks_real",
                              sum(len(payloads[i]) for i in chunk) // bs)
                backend.count("batch.blocks_launched", padded * bucket)
                yield chunk, flats, valid

    def _launch(self, flats: torch.Tensor, valid: list):
        """Queue one batch: its upload, its step, and the copies of what the host
        needs back. A host estimator's batch stops at its region rows: -> (the batch
        on the device, the rows), which :meth:`_serialize` scores and finishes."""
        self.batches += 1
        with self.times("h2d"):
            x = backend.to_device(flats, self.device)
        with self.times("device"):
            regions = self._step.regions(x, valid)
            if not self.estimator.scores_on_device:
                return x, regions
            outs = self._step.finish(x, regions)
        with self.times("d2h"):
            return backend.Download(outs)

    def process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
        """Transform every payload; results returned in submission order."""
        order: List[Optional[BatchResult]] = [None] * len(payloads)
        self.batches = 0
        pending = deque()
        with self.times.call(len(payloads)):
            for chunk, flats, valid in self._prepare_batches(payloads, order):
                pending.append((chunk, self._launch(flats, valid)))
                if len(pending) >= 2:
                    self._serialize(payloads, order, *pending.popleft())
            while pending:
                self._serialize(payloads, order, *pending.popleft())
        return [r for r in order if r is not None]

    def _serialize(self, payloads, order, chunk, launched) -> None:
        """The card wrote each file's transformed bytes at the start of its row: the
        host copier fills a new ``bytes`` a file from them in one call. A host
        estimator scores the batch's rows first, and the rows kernel's launch and the
        download are queued behind its scores."""
        if not self.estimator.scores_on_device:
            with self.times("score"):
                outs = self._step.finish(*launched)
            with self.times("d2h"):
                launched = backend.Download(outs)
        with self.times("d2h"):
            rows, best = launched.wait()
        with self.times("serialize"):
            outs = [host_copy.new_bytes(len(payloads[i])) for i in chunk]
            host_copy.copy([(out, rows[row], len(out), len(out))
                            for row, out in enumerate(outs)])
            for file_idx, out, pick in zip(chunk, outs, best.tolist()):
                order[file_idx] = BatchResult(file_idx, out, self.candidates[pick])
        backend.count("batch.files_device_bytes", len(chunk))


class Bc1BatchProcessor(BatchProcessor):
    def __init__(self, mesh=None, candidates=None, max_batch: int = 64, **kw):
        super().__init__("bc1", mesh, candidates, max_batch, **kw)


class Bc2BatchProcessor(BatchProcessor):
    def __init__(self, mesh=None, candidates=None, max_batch: int = 64, **kw):
        super().__init__("bc2", mesh, candidates, max_batch, **kw)


class Bc3BatchProcessor(BatchProcessor):
    def __init__(self, mesh=None, candidates=None, max_batch: int = 64, **kw):
        super().__init__("bc3", mesh, candidates, max_batch, **kw)


class Bc4BatchProcessor(BatchProcessor):
    def __init__(self, mesh=None, candidates=None, max_batch: int = 64, **kw):
        super().__init__("bc4", mesh, candidates, max_batch, **kw)


class Bc5BatchProcessor(BatchProcessor):
    def __init__(self, mesh=None, candidates=None, max_batch: int = 64, **kw):
        super().__init__("bc5", mesh, candidates, max_batch, **kw)


def transform_corpus_bc1(payloads: Sequence[bytes], mesh=None,
                         candidates=BC1_FAST_CANDIDATES,
                         device: Union[str, torch.device] = "cuda") -> List[BatchResult]:
    """One-shot convenience wrapper over :class:`Bc1BatchProcessor`."""
    return Bc1BatchProcessor(mesh, candidates, device=device).process(payloads)


# --- the batched load path --------------------------------------------------------------

# Per format: block size, stream spec and the untransform kernel's wrapper (on a
# flat batch), or the per-file untransform (``file``) of the formats without a
# stacked form: the mode stream and the pixel layouts.
_UNTRANSFORM = {
    "bc1": dict(block_size=8, spec=hostwrap.bc1_stream_spec,
                kernel=lambda x, s: shuffle.bc1_untransform(
                    x, int(s.decorrelation_mode), s.split_colour_endpoints)),
    "bc2": dict(block_size=16, spec=hostwrap.bc2_stream_spec,
                kernel=lambda x, s: shuffle.bc2_untransform(
                    x, int(s.decorrelation_mode), s.split_colour_endpoints)),
    "bc3": dict(block_size=16, spec=hostwrap.bc3_stream_spec,
                kernel=lambda x, s: shuffle.bc3_untransform(
                    x, int(s.decorrelation_mode), s.split_alpha_endpoints,
                    s.split_colour_endpoints)),
    "bc4": dict(block_size=8, spec=lambda s: ops_bc45.bc4_spec(s.split_endpoints),
                kernel=lambda x, s: shuffle.bc4_untransform(x, s.split_endpoints)),
    "bc5": dict(block_size=16, spec=lambda s: ops_bc45.bc5_spec(s.split_endpoints),
                kernel=lambda x, s: shuffle.bc5_untransform(x, s.split_endpoints)),
    "bc7": dict(file=ops_bc7.untransform),
    "bc6h": dict(file=ops_bc6h.untransform),
    **{layout: dict(file=(lambda p, s, device, _l=layout:
                          ops_rgb.untransform(p, _l, s, device=device)))
       for layout in ("rgba8888", "bgra8888", "bgr888")},
}


class UntransformBatchProcessor:
    """Batch untransform twin of :class:`BatchProcessor`: the load path.

    Transformed BC1-BC5 payloads are grouped by (settings, bucket); each file's
    stream sections are laid into bucket-padded per-stream sections of one flat
    buffer, so that B files form one valid transformed payload of B·bucket blocks
    (the untransform is linear in the block index: output block i reads only
    element i of each stream), and one launch of the format's untransform kernel
    inverts the batch. A batch holds about twice its payload on the device, so
    large buckets shrink the batch to ``DLT_UNTRANSFORM_HBM_BUDGET`` bytes (2 GiB by
    default). BC7/BC6H and RGB payloads take the per-file untransform."""

    def __init__(self, fmt: str, max_batch: int = 64,
                 device: Union[str, torch.device] = "cuda", timing: bool = False):
        self.fmt = fmt
        self.cfg = _UNTRANSFORM[fmt]
        self.max_batch = max_batch
        self.device = backend.resolve_device(device)
        self.times = StageTimes(self.device, timing, "untransform")
        #: untransform batches (BC1-BC5) run by the last :meth:`process`
        self.batches = 0

    def process(self, entries: Sequence[tuple]) -> List[bytes]:
        """``entries`` = [(transformed payload bytes, settings), ...]; returns the
        restored payloads in submission order."""
        with self.times.call(len(entries)):
            return self._process(entries)

    def _process(self, entries: Sequence[tuple]) -> List[bytes]:
        out: List[Optional[bytes]] = [None] * len(entries)
        self.batches = 0
        by_group: dict = {}
        bs = self.cfg.get("block_size")
        for i, (payload, settings) in enumerate(entries):
            if len(payload) == 0:
                out[i] = b""
            elif "file" in self.cfg:
                out[i] = self.cfg["file"](payload, settings, device=self.device)
            elif len(payload) % bs:
                raise ValueError(
                    f"payload {i}: length {len(payload)} not divisible by {bs}")
            else:
                by_group.setdefault((settings, lanes.bucket_size(len(payload) // bs)),
                                    []).append(i)
        budget = int(os.environ.get("DLT_UNTRANSFORM_HBM_BUDGET", str(2 << 30)))
        pending = deque()
        for (settings, bucket), indices in sorted(
                by_group.items(), key=lambda kv: (repr(kv[0][0]), kv[0][1])):
            eff_batch = max(1, min(self.max_batch, budget // (2 * bs * bucket)))
            for start in range(0, len(indices), eff_batch):
                chunk = indices[start:start + eff_batch]
                pending.append((chunk, bucket,
                                self._launch(entries, chunk, settings, bucket)))
                if len(pending) >= 2:  # assemble the next batch while this one runs
                    self._drain(entries, out, *pending.popleft())
        while pending:
            self._drain(entries, out, *pending.popleft())
        return [r for r in out if r is not None]

    def _launch(self, entries, chunk, settings, bucket) -> backend.Download:
        """Lay each file's stream sections into the batch's bucket-padded sections,
        and queue the upload, the one untransform launch and the download."""
        self.batches += 1
        bs, B = self.cfg["block_size"], len(chunk)
        with self.times("assemble"):
            flat = backend.host_buffer(bs * B * bucket, torch.uint8, self.device)
            host = flat.numpy()
            base = before = 0  # the section's start; bytes per block of earlier streams
            for bpb in self.cfg["spec"](settings):
                sections = host[base:base + bpb * B * bucket].reshape(B, bpb * bucket)
                for row, idx in enumerate(chunk):
                    payload = entries[idx][0]
                    n = len(payload) // bs
                    sections[row, :bpb * n] = np.frombuffer(payload, np.uint8, bpb * n,
                                                            before * n)
                    sections[row, bpb * n:] = 0
                base += bpb * B * bucket
                before += bpb
        with self.times("h2d"):
            x = backend.to_device(flat, self.device)
        with self.times("device"):
            y = self.cfg["kernel"](x, settings)
        with self.times("d2h"):
            return backend.Download([y])

    def _drain(self, entries, out, chunk, bucket, download) -> None:
        bs = self.cfg["block_size"]
        with self.times("d2h"):
            rows = download.wait()[0].reshape(len(chunk), bs * bucket)
        with self.times("serialize"):
            for row, idx in enumerate(chunk):
                out[idx] = rows[row, :len(entries[idx][0])].tobytes()


class ModeSortBatchProcessor:
    """BC7/BC6H corpus batching (JAX ``pipeline.py:683``): per batch, every file's
    candidate streams are written into rows of one tensor and scored by one count
    call (:func:`..ops.bc7.auto_step_batched_modesort`); only the winners come back,
    and go through one zstd-1 identity guard call for the whole batch
    (:func:`..ops.bc7.ltu_identity_guard_batch`), as the per-file LTU auto-search
    runs it. Each file holds its candidates' whole streams on the device at once, so
    large buckets shrink the batch to ``DLT_MODESORT_HBM_BUDGET`` bytes (1 GiB by
    default). ``timing`` as in :class:`BatchProcessor`, the guard a stage of its
    own."""

    BLOCK_SIZE = 16

    def __init__(self, fmt: str = "bc7", max_batch: int = 64, candidates=None,
                 device: Union[str, torch.device] = "cuda", timing: bool = False):
        if fmt not in ("bc7", "bc6h"):
            raise ValueError(f"mode-sort batching is for bc7/bc6h, not {fmt}")
        self.fmt = fmt
        self.settings = tuple(candidates if candidates is not None else
                              (BC7_FAST_CANDIDATES if fmt == "bc7"
                               else BC6H_FAST_CANDIDATES))
        self._cand_key = tuple((s.sort_by_mode, s.split_byte_planes)
                               for s in self.settings)
        self.max_batch = max_batch
        self.device = backend.resolve_device(device)
        self.times = StageTimes(self.device, timing, "modesort")
        #: device batches run by the last :meth:`process`
        self.batches = 0
        #: each file's pick before the identity guard (an index into the
        #: candidates), in submission order, from the last :meth:`process`
        self.picks: List[int] = []

    def process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
        with self.times.call(len(payloads)):
            return self._process(payloads)

    def _process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
        order: List[Optional[BatchResult]] = [None] * len(payloads)
        self.batches = 0
        self.picks = [len(self.settings) - 1] * len(payloads)
        by_bucket: dict = {}
        for i, data in enumerate(payloads):
            if len(data) % self.BLOCK_SIZE:
                raise ValueError(
                    f"payload {i}: length {len(data)} not divisible by 16")
            n = len(data) // self.BLOCK_SIZE
            if n == 0:
                order[i] = BatchResult(i, b"", self.settings[-1])
                continue
            by_bucket.setdefault(lanes.bucket_size(n), []).append(i)
        budget = int(os.environ.get("DLT_MODESORT_HBM_BUDGET", str(1 << 30)))
        fmt = ops_bc7.BC7 if self.fmt == "bc7" else ops_bc7.BC6H
        for bucket, indices in sorted(by_bucket.items()):
            per_file = len(self._cand_key) * ops_bc7.stream_row_len(bucket)
            eff_batch = max(1, min(self.max_batch, budget // per_file))
            for start in range(0, len(indices), eff_batch):
                chunk = indices[start:start + eff_batch]
                self.batches += 1
                with self.times("assemble"):
                    flats = backend.host_buffer((len(chunk), 16 * bucket), torch.uint8,
                                                self.device)
                    host = flats.numpy()
                    for row, idx in enumerate(chunk):
                        host[row, :len(payloads[idx])] = np.frombuffer(payloads[idx],
                                                                       np.uint8)
                with self.times("h2d"):
                    x = backend.to_device(flats, self.device)
                with self.times("device"):
                    out = ops_bc7.auto_step_batched_modesort(
                        x, [len(payloads[i]) // 16 for i in chunk], self._cand_key,
                        DEFAULT_OFFSETS, fmt)
                with self.times("d2h"):
                    winner, valid, best = backend.Download(out).wait()
                with self.times("guard"):
                    shipped = ops_bc7.ltu_identity_guard_batch(
                        [payloads[i] for i in chunk],
                        [winner[row, :int(valid[row])].tobytes()
                         for row in range(len(chunk))],
                        [self.settings[int(b)] for b in best], self.settings)
                for row, idx in enumerate(chunk):
                    self.picks[idx] = int(best[row])
                    order[idx] = BatchResult(idx, *shipped[row])
        return [r for r in order if r is not None]


class RgbBatchProcessor:
    """Uncompressed RGB(A) corpus batching (JAX ``pipeline.py:771``): per batch of
    ``max_batch`` files, every file's distinct candidate streams are written into
    rows of one tensor (the identity's row is a copy of the payload) and scored in
    one call, each row at its own length: one count launch under LTU; a host
    estimator scores the rows on the host. Only the winners come back. ``timing``
    as in :class:`BatchProcessor`."""

    def __init__(self, layout: str, estimator, max_batch: int = 64, candidates=None,
                 device: Union[str, torch.device] = "cuda", timing: bool = False):
        self.layout = layout
        self.estimator = estimator
        self.settings = tuple(candidates if candidates is not None
                              else RGB_FAST_CANDIDATES)
        self.max_batch = max_batch
        self.device = backend.resolve_device(device)
        self.times = StageTimes(self.device, timing, "rgb")
        #: device batches run by the last :meth:`process`
        self.batches = 0

    def process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
        with self.times.call(len(payloads)):
            return self._process(payloads)

    def _process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
        order: List[Optional[BatchResult]] = [None] * len(payloads)
        self.batches = 0
        live = [i for i, p in enumerate(payloads) if len(p)]
        for i, p in enumerate(payloads):
            if len(p):
                ops_rgb._stride(p, self.layout)
            else:
                order[i] = BatchResult(i, b"", self.settings[-1])
        keys, index = distinct([(c.decorrelate, c.split_channels) for c in self.settings])
        K = len(keys)
        for start in range(0, len(live), self.max_batch):
            chunk = live[start:start + self.max_batch]
            self.batches += 1
            sizes = [len(payloads[i]) for i in chunk]
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            with self.times("assemble"):
                flat = backend.host_buffer(sum(sizes), torch.uint8, self.device)
                for idx, pos, size in zip(chunk, offsets, sizes):
                    flat.numpy()[pos:pos + size] = np.frombuffer(payloads[idx], np.uint8)
            with self.times("h2d"):
                x = backend.to_device(flat, self.device)
            with self.times("device"):
                rows = torch.empty((len(chunk), K, max(sizes)), dtype=torch.uint8,
                                   device=self.device)
                for row, (pos, size) in enumerate(zip(offsets, sizes)):
                    for k, (dec, split) in enumerate(keys):
                        src, dst = x[pos:pos + size], rows[row, k, :size]
                        if dec or split:
                            channels.rgb_transform(src, *channels.LAYOUTS[self.layout],
                                                   dec, split, out=dst)
                        else:
                            dst.copy_(src)
                lengths = torch.tensor([[size] * K for size in sizes], dtype=torch.int64)
                scores = self.estimator.estimate_batch_device(
                    rows.view(len(chunk) * K, -1), lengths.view(-1))
                best = torch.argmin(scores.view(len(chunk), K)[:, index], dim=1)
                key_of = torch.tensor(index).to(self.device, non_blocking=True)[best]
                winner = rows[torch.arange(len(chunk), device=self.device), key_of]
            with self.times("d2h"):
                winner, best = backend.Download([winner, best]).wait()
            with self.times("serialize"):
                for row, (idx, size) in enumerate(zip(chunk, sizes)):
                    order[idx] = BatchResult(idx, winner[row, :size].tobytes(),
                                             self.settings[int(best[row])])
        return [r for r in order if r is not None]
