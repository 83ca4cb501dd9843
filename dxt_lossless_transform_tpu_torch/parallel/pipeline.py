"""Corpus batch pipeline: many textures per device step, on one device or a mesh.

Counterpart of ``dxt_lossless_transform_tpu/parallel/pipeline.py``. Payloads of one
format are grouped by padded block-count bucket (:func:`..ops.lanes.bucket_size`),
stacked into (files x words) batches, auto-searched and transformed with one launch
of each kernel per batch (:mod:`.sharded`), and returned in submission order as
:class:`BatchResult`. The results equal the port's per-file auto-search on the same
payload and estimator, in settings and bytes, and the JAX package's batch pipeline.

- :class:`BatchProcessor` (BC1-BC5): device-scored under LTU (the CLI's ``medium``
  preset; the JAX scorer's exact integer twin), or host-scored with an
  ``estimator`` (``ZstdEstimation(1)``, the ``optimal``/``max`` presets: the device
  builds every candidate's region row and the host ranks them).
- :class:`ModeSortBatchProcessor` (BC7/BC6H) and :class:`RgbBatchProcessor`: every
  file's candidate streams scored in one count call per batch.
- :class:`UntransformBatchProcessor`, the batched load path: BC1-BC5 files grouped
  by (settings, bucket), each file's streams laid out bucket-padded side by side,
  and the whole batch inverted by one launch of the format's untransform kernel;
  BC7/BC6H and RGB payloads go through the per-file untransform.

In both of the BC1-BC5 processor's modes and in the load path, the next batch's
upload and kernels are queued before the host serializes (or scores) the current
one, whose results come back through pinned buffers (:class:`..backend.Download`).
The device is CUDA unless the caller passes ``device="cpu"``, which runs the
kernels' plain versions. With a ``mesh`` (:func:`.mesh.make_mesh`) the BC1-BC5
processor, in both modes, runs the sharded steps on the mesh's devices (its
``device`` argument gives way to them): a batch is padded to a multiple of the files
axis by repeating its last file, as in JAX, and the results are the same.

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

from .. import backend, endian
from ..estimate.ltu import DEFAULT_OFFSETS
from ..ops import bc45 as ops_bc45, bc6h as ops_bc6h, bc7 as ops_bc7
from ..ops import hostwrap, lanes, rgb as ops_rgb
from ..ops.auto import distinct
from ..ops.cuda import channels, shuffle
from ..settings import (
    BC1_FAST_CANDIDATES, BC2_FAST_CANDIDATES, BC3_FAST_CANDIDATES,
    BC6H_FAST_CANDIDATES, BC7_FAST_CANDIDATES, RGB_FAST_CANDIDATES,
    Bc4TransformSettings, Bc5TransformSettings,
)
from . import mesh as mesh_lib, sharded


@dataclass
class BatchResult:
    """One file's outcome, in submission order."""

    index: int
    transformed: bytes
    settings: object


def _u16s(arr, n) -> bytes:
    return endian.to_bytes(arr[:n], "u2")


def _u32s(arr, n) -> bytes:
    return endian.to_bytes(arr[:n], "u4")


def _pair_u16(a, b, n) -> bytes:
    out = endian.empty((n, 2), "u2")
    out[:, 0] = a[:n]
    out[:, 1] = b[:n]
    return endian.to_bytes(out, "u2")


def _colours(d0, d1, n, split: bool) -> bytes:
    return (_u16s(d0, n) + _u16s(d1, n)) if split else _pair_u16(d0, d1, n)


def _serialize_bc1(streams, n, s) -> bytes:
    d0, d1, idx = streams
    return _colours(d0, d1, n, s.split_colour_endpoints) + _u32s(idx, n)


def _alpha_words(a_lo, a_hi, n) -> bytes:
    alpha = endian.empty((n, 2), "u4")
    alpha[:, 0] = a_lo[:n]
    alpha[:, 1] = a_hi[:n]
    return endian.to_bytes(alpha, "u4")


def _serialize_bc2(streams, n, s) -> bytes:
    a_lo, a_hi, d0, d1, idx = streams
    return (_alpha_words(a_lo, a_hi, n) + _colours(d0, d1, n, s.split_colour_endpoints)
            + _u32s(idx, n))


def _idx_u16s(h1, h2, h3, n) -> bytes:
    """Three u16 index lanes -> the interleaved per-block 6-byte index stream."""
    idx = endian.empty((n, 3), "u2")
    idx[:, 0], idx[:, 1], idx[:, 2] = h1[:n], h2[:n], h3[:n]
    return endian.to_bytes(idx, "u2")


def _ep_bytes(ep, n, split: bool) -> bytes:
    if split:
        return ((ep[:n] & 0xFF).astype(np.uint8).tobytes()
                + ((ep[:n] >> 8) & 0xFF).astype(np.uint8).tobytes())
    return _u16s(ep, n)


def _serialize_bc3(streams, n, s) -> bytes:
    ep, h1, h2, h3, d0, d1, cidx = streams
    return (_ep_bytes(ep, n, s.split_alpha_endpoints) + _idx_u16s(h1, h2, h3, n)
            + _colours(d0, d1, n, s.split_colour_endpoints) + _u32s(cidx, n))


def _serialize_bc4(streams, n, s) -> bytes:
    ep, h1, h2, h3 = streams
    return _ep_bytes(ep, n, s.split_endpoints) + _idx_u16s(h1, h2, h3, n)


def _serialize_bc5(streams, n, s) -> bytes:
    r_ep, g_ep, rh1, rh2, rh3, gh1, gh2, gh3 = streams
    return (_ep_bytes(r_ep, n, s.split_endpoints) + _ep_bytes(g_ep, n, s.split_endpoints)
            + _idx_u16s(rh1, rh2, rh3, n) + _idx_u16s(gh1, gh2, gh3, n))


# block_size, words per block, the default candidates, the serializer, the step's
# candidate key and which of the step's lanes are 16-bit values (downloaded as int16)
_FORMATS = {
    "bc1": dict(block_size=8, words=2, candidates=BC1_FAST_CANDIDATES,
                serialize=_serialize_bc1, u16=(0, 1),
                key=lambda c: (int(c.decorrelation_mode), c.split_colour_endpoints)),
    "bc2": dict(block_size=16, words=4, candidates=BC2_FAST_CANDIDATES,
                serialize=_serialize_bc2, u16=(2, 3),
                key=lambda c: (int(c.decorrelation_mode), c.split_colour_endpoints)),
    "bc3": dict(block_size=16, words=4, candidates=BC3_FAST_CANDIDATES,
                serialize=_serialize_bc3, u16=(0, 1, 2, 3, 4, 5),
                key=lambda c: (int(c.decorrelation_mode), c.split_alpha_endpoints,
                               c.split_colour_endpoints)),
    "bc4": dict(block_size=8, words=2,
                candidates=tuple(Bc4TransformSettings.all_combinations()),
                serialize=_serialize_bc4, u16=(0, 1, 2, 3),
                key=lambda c: (c.split_endpoints,)),
    "bc5": dict(block_size=16, words=4,
                candidates=tuple(Bc5TransformSettings.all_combinations()),
                serialize=_serialize_bc5, u16=tuple(range(8)),
                key=lambda c: (c.split_endpoints,)),
}


class StageTimes:
    """Seconds spent in each stage of a processor's batches, kept only when
    ``enabled``: then the device is synchronised around each stage, which stops the
    batches from overlapping, so that each stage's time is its own."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device, self.enabled = device, enabled
        self.seconds: dict = {}

    @contextmanager
    def __call__(self, stage: str):
        if not self.enabled:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        start = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[stage] = self.seconds.get(stage, 0.0) + time.perf_counter() - start


def _as_unsigned(a: np.ndarray) -> np.ndarray:
    return a.view({np.dtype(np.int16): np.uint16, np.dtype(np.int32): np.uint32}.get(
        a.dtype, a.dtype))


class BatchProcessor:
    """Pack payloads of one texture format into bucket-sized batches and
    auto-transform them on the device.

    Without an ``estimator`` the device scores every candidate under LTU and keeps
    the argmin; with one (a host estimator such as ``ZstdEstimation(1)``) the device
    builds every candidate's region row and the host scores them. With a ``mesh``
    the steps run sharded over it, each batch uploaded to ``mesh.home``. ``timing``
    keeps each stage's seconds in :attr:`times` (and serializes the batches)."""

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
        self.estimator = estimator
        self.device = mesh.home if mesh is not None else backend.resolve_device(device)
        if estimator is not None:
            self._step = sharded.auto_step_batched_regions(fmt, self._cand_key, mesh)
        elif mesh is not None:
            self._step = sharded.auto_step(fmt, mesh, self._cand_key, DEFAULT_OFFSETS)
        else:
            self._step = sharded.auto_step_batched(fmt, self._cand_key, DEFAULT_OFFSETS)
        self.times = StageTimes(self.device, timing)
        #: device batches run by the last :meth:`process`
        self.batches = 0

    def _prepare_batches(self, payloads: Sequence[bytes], order):
        """Bucket payloads into (chunk, host flats, valid lengths) batches; under a
        mesh a batch is padded to a multiple of the files axis with copies of its
        last file."""
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
                with self.times("assemble"):
                    flats = backend.host_buffer((padded, wpb * bucket), torch.int32,
                                                self.device)
                    # the payloads' bytes as they are: the card reads them as
                    # little-endian words, so nothing is reinterpreted on the host
                    host = flats.numpy().view(np.uint8)
                    valid = []
                    for row, idx in enumerate(chunk):
                        size = len(payloads[idx])
                        host[row, :size] = np.frombuffer(payloads[idx], np.uint8)
                        host[row, size:] = 0
                        valid.append(4 * (size // bs))
                    host[len(chunk):] = host[len(chunk) - 1]
                    valid += valid[-1:] * (padded - len(chunk))
                yield chunk, flats, valid

    def _launch(self, flats: torch.Tensor, valid: list) -> backend.Download:
        """Queue one batch: its upload, its step, and the copies of what the host
        needs back."""
        self.batches += 1
        with self.times("h2d"):
            x = backend.to_device(flats, self.device)
        with self.times("device"):
            outs = list(self._step(x, valid))
            if self.estimator is None:
                for i in self.cfg["u16"]:
                    outs[i] = outs[i].to(torch.int16)
        with self.times("d2h"):
            return backend.Download(outs)

    def process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
        """Transform every payload; results returned in submission order."""
        order: List[Optional[BatchResult]] = [None] * len(payloads)
        self.batches = 0
        finish = self._serialize if self.estimator is None else self._score_and_serialize
        pending = deque()
        for chunk, flats, valid in self._prepare_batches(payloads, order):
            pending.append((chunk, self._launch(flats, valid)))
            if len(pending) >= 2:
                finish(payloads, order, *pending.popleft())
        while pending:
            finish(payloads, order, *pending.popleft())
        return [r for r in order if r is not None]

    def _serialize(self, payloads, order, chunk, download) -> None:
        bs = self.cfg["block_size"]
        with self.times("d2h"):
            out = [_as_unsigned(a) for a in download.wait()]
        with self.times("serialize"):
            streams, best = out[:-1], out[-1]
            for row, file_idx in enumerate(chunk):
                n = len(payloads[file_idx]) // bs
                settings = self.candidates[int(best[row])]
                order[file_idx] = BatchResult(
                    file_idx, self.cfg["serialize"]([s[row] for s in streams], n,
                                                    settings), settings)

    # --- host-scored (zstd-preset) mode -------------------------------------------

    def _score_and_serialize(self, payloads, order, chunk, download) -> None:
        bs = self.cfg["block_size"]
        with self.times("d2h"):
            outs = [_as_unsigned(a) for a in download.wait()]
        ns = [len(payloads[i]) // bs for i in chunk]
        if self.fmt == "bc3":
            h1, h2, h3, cidx, a_rows, c_rows = outs
            alpha_keys, colour_keys, ai, ci = sharded._bc3_keys(self._cand_key)
            A, K = len(alpha_keys), len(colour_keys)
            with self.times("score"):
                bufs = []
                for row, n in enumerate(ns):
                    bufs += [a_rows[row, a, :2 * n].tobytes() for a in range(A)]
                    bufs += [c_rows[row, c, :4 * n].tobytes() for c in range(K)]
                sizes = np.asarray(self.estimator.estimate_batch(bufs)).reshape(
                    len(ns), A + K)
            with self.times("serialize"):
                for row, (file_idx, n) in enumerate(zip(chunk, ns)):
                    scores = sizes[row, ai] + sizes[row, [A + c for c in ci]]
                    best = int(np.argmin(scores))
                    out = (a_rows[row, ai[best], :2 * n].tobytes()
                           + _idx_u16s(h1[row], h2[row], h3[row], n)
                           + c_rows[row, ci[best], :4 * n].tobytes()
                           + _u32s(cidx[row], n))
                    order[file_idx] = BatchResult(file_idx, out, self.candidates[best])
            return
        C = len(self._cand_key)

        def region(row: int, c: int, n: int) -> bytes:
            """Candidate c's region of the file in ``row``: its on-disk colour
            (BC1/BC2) or endpoint section (BC4; BC5 red then green, as the per-file
            auto scores it)."""
            if self.fmt == "bc4":
                return outs[3][row, c, :2 * n].tobytes()
            if self.fmt == "bc5":
                return outs[6][row, c, :2 * n].tobytes() + outs[7][row, c, :2 * n].tobytes()
            return outs[-1][row, c, :4 * n].tobytes()

        with self.times("score"):
            sizes = np.asarray(self.estimator.estimate_batch(
                [region(row, c, n) for row, n in enumerate(ns) for c in range(C)])
            ).reshape(len(ns), C)
        with self.times("serialize"):
            for row, (file_idx, n) in enumerate(zip(chunk, ns)):
                best = int(np.argmin(sizes[row]))
                head = region(row, best, n)
                if self.fmt == "bc1":
                    out = head + _u32s(outs[0][row], n)
                elif self.fmt == "bc2":
                    out = (_alpha_words(outs[0][row], outs[1][row], n) + head
                           + _u32s(outs[2][row], n))
                elif self.fmt == "bc4":
                    out = head + _idx_u16s(outs[0][row], outs[1][row], outs[2][row], n)
                else:
                    out = head + _idx_u16s(*(o[row] for o in outs[0:3]), n) \
                        + _idx_u16s(*(o[row] for o in outs[3:6]), n)
                order[file_idx] = BatchResult(file_idx, out, self.candidates[best])


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
        self.times = StageTimes(self.device, timing)
        #: untransform batches (BC1-BC5) run by the last :meth:`process`
        self.batches = 0

    def process(self, entries: Sequence[tuple]) -> List[bytes]:
        """``entries`` = [(transformed payload bytes, settings), ...]; returns the
        restored payloads in submission order."""
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
        self.times = StageTimes(self.device, timing)
        #: device batches run by the last :meth:`process`
        self.batches = 0
        #: each file's pick before the identity guard (an index into the
        #: candidates), in submission order, from the last :meth:`process`
        self.picks: List[int] = []

    def process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
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
        self.times = StageTimes(self.device, timing)
        #: device batches run by the last :meth:`process`
        self.batches = 0

    def process(self, payloads: Sequence[bytes]) -> List[BatchResult]:
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
