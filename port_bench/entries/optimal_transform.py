"""Build traffic under the CLI's default preset, ``optimal``: each call is one stream
window of BC3 texture files, routed as ``transform --preset optimal`` routes them, by
the program's own ``cli.main._batchable``:

- files of at most 8 MiB of payload, in one list, through the host-scored
  ``BatchProcessor("bc3", estimator=ZstdEstimation(1))`` that
  ``cli.main._batch_processors_for_preset("optimal", max_batch)`` builds (every
  distinct region built on the card, zstd-1 scored on the host);
- every larger file, as a DDS file in memory (its 128-byte legacy DXT5 header, made
  with the pool, then its payload), through
  ``formats.api.transform_slice_with_multiple_handlers`` with the preset's bundle:
  the CLI's per-file call without the file read and write.

Checked: each answer's settings against the reference's zstd-1 search
(``reference/bc3_zstd.py``), its payload bytes against the reference's transform
under those settings, and for a per-file answer its header: the transform header
word of the reference's settings over the magic, every other header byte unchanged.
The search is exact integer work on exact compressed sizes, with no lower precision
to step down to, so the controls break the guarantee it gives, with the reference in
the program's place: ``skip_search`` ships every file under the FAST list's last
candidate, as a program that dropped the search would; ``ltu_search`` ships the
``medium`` preset's pick (the exact LTU search, ``reference/bc3.search``), as a
program that scored with the cheaper estimator would.
"""

from __future__ import annotations

import struct
from types import SimpleNamespace

import torch

from port_bench import bounds, pool as pool_lib, spans, trace as trace_lib
from port_bench.reference import bc3, bc3_zstd

CONTROLS = ("skip_search", "ltu_search")
HEADER_SIZE = 128
# bytes a block of the FAST candidates' distinct scored regions: 2 an alpha section,
# 4 a colour section
REGION_BYTES = (2 * len({c["split_alpha_endpoints"] for c in bc3.FAST})
                + 4 * len({(c["decorrelation_mode"], c["split_colour_endpoints"])
                           for c in bc3.FAST}))
# bytes a block the batch step writes besides them: the alpha indices (6) and the
# colour indices (4)
INDEX_BYTES = 10


def dds_header(size: int) -> bytes:
    """The legacy DDS header (magic and 124 bytes) of a size x size DXT5 texture
    with its full mip chain."""
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x20000 | 0x80000  # caps, height, width,
    # pixel format, mip count, linear size
    caps = 0x8 | 0x1000 | 0x400000                        # complex, texture, mipmap
    top = ((size + 3) // 4) ** 2 * bc3.BLOCK_SIZE
    return (struct.pack("<4s7I44x", b"DDS ", 124, flags, size, size, top, 0,
                        size.bit_length())
            + struct.pack("<2I4s5I", 32, 0x4, b"DXT5", 0, 0, 0, 0, 0)
            + struct.pack("<5I", caps, 0, 0, 0, 0))


def _settings_of(word: int):
    try:
        return bc3.settings_of(word)
    except ValueError:
        return None


def _same(program_settings, ref: dict) -> bool:
    try:
        return all(int(getattr(program_settings, k)) == int(v) for k, v in ref.items())
    except (AttributeError, TypeError, ValueError):
        return False


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device,
                 trace: bool):
        if config["format"] != "bc3":
            raise ValueError(f"optimal_transform runs BC3, not {config['format']!r}")
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.pool = []
        self.proc = None
        self.bound_s = []

    # --- set-up -------------------------------------------------------------------
    def make_pool(self) -> None:
        """The pool, each file's route, and the DDS file of each per-file one."""
        from dxt_lossless_transform_tpu_torch.cli import main as cli

        self.pool = pool_lib.make_pool(self.config, self.seed, self.device)
        self.sizes = [len(f.payload) for f in self.pool]
        self.batched = [cli._batchable(self.config["format"], n, self.config["preset"])
                        for n in self.sizes]
        self.blobs = {i: dds_header(f.size) + f.payload
                      for i, f in enumerate(self.pool) if not self.batched[i]}

    def reference_setup(self) -> None:
        """Each pool file's bound: the uploaded payload read and its distinct regions
        written by the region kernel, with the index streams on the batch route and
        the winner's transform on the per-file one."""
        bs = bc3.BLOCK_SIZE
        for i, f in enumerate(self.pool):
            n = f.blocks
            if self.batched[i]:
                nbytes = bounds.regions_bytes(bs, n, (REGION_BYTES + INDEX_BYTES) * n)
            else:
                nbytes = (bounds.regions_bytes(bs, n, REGION_BYTES * n)
                          + bounds.transform_bytes(bs, n))
            self.bound_s.append(bounds.bytes_seconds(nbytes))

    def program_setup(self) -> None:
        from dxt_lossless_transform_tpu_torch.cli import main as cli
        from dxt_lossless_transform_tpu_torch.formats import api

        preset = self.config["preset"]
        self.proc = cli._batch_processors_for_preset(
            preset, int(self.mix["max_batch"]), self.device)(self.config["format"])
        self.handlers = cli.all_handlers(self.device)
        self.bundle = cli.make_preset_bundle(preset)
        self.per_file = api.transform_slice_with_multiple_handlers

    def warmup_calls(self, calls) -> list:
        """One call holding one file of each size (both routes), then the stream's
        first ``warmup_calls`` calls."""
        first = {}
        for i, f in enumerate(self.pool):
            first.setdefault(f.size, i)
        return [list(first.values())] + [next(calls)
                                         for _ in range(int(self.mix["warmup_calls"]))]

    # --- the timed path ---------------------------------------------------------------
    def call(self, files):
        """-> (the positions in ``files`` of the batched files, the batch's results,
        [(position, transformed DDS file)] of the per-file ones)."""
        batch = [j for j, i in enumerate(files) if self.batched[i]]
        results = (self.proc.process([self.pool[files[j]].payload for j in batch])
                   if batch else [])
        singles = [(j, self.per_file(self.handlers, self.blobs[i], self.bundle, ".dds"))
                   for j, i in enumerate(files) if not self.batched[i]]
        return batch, results, singles

    def call_bytes(self, files) -> int:
        return sum(self.sizes[i] for i in files)

    @staticmethod
    def answer_bytes(answers) -> int:
        _, results, singles = answers
        return sum(len(r.transformed) for r in results) + sum(len(o) for _, o in singles)

    def release(self) -> None:
        self.proc = None

    # --- traced run ---------------------------------------------------------------
    def bound_seconds(self, files) -> float:
        return sum(self.bound_s[i] for i in files)

    def stage_pass(self, calls, n_calls: int) -> dict:
        """``n_calls`` more calls under the profiler, each call's answers held until
        the next returns, as the window holds them: the program's spans' self
        seconds (``spans.reduce``), the counters' change, and the calls' payload
        bytes, all and the batch route's. The profiler is opened here, not through
        ``trace.profile``, which ``spans.traced_run`` replaces to take the
        window's records."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from dxt_lossless_transform_tpu_torch import backend

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        nbytes = batch_bytes = 0
        held = None
        before = backend.counters()
        with profile(activities=acts) as prof:
            with record_function(trace_lib.WINDOW):
                for _ in range(n_calls):
                    files = next(calls)
                    held = self.call(files)
                    nbytes += self.call_bytes(files)
                    batch_bytes += self.call_bytes([i for i in files if self.batched[i]])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        del held
        rec = spans.reduce(trace_lib.from_kineto(prof.profiler.kineto_results.events()),
                           before, backend.counters())
        return {"stage_span_self_s": rec["span_self_s"], "stage_counters": rec["counters"],
                "stage_bytes": nbytes, "stage_batch_bytes": batch_bytes}

    # --- the reference, after the window ----------------------------------------------
    def _upload(self, i: int) -> torch.Tensor:
        return torch.frombuffer(bytearray(self.pool[i].payload),
                                dtype=torch.uint8).to(self.device)

    def _file_answer(self, i: int, settings: dict, data: bytes) -> bytes:
        """The per-file route's answer for pool file ``i`` shipped under ``settings``
        with transformed payload ``data``."""
        return (struct.pack("<I", bc3.header(settings)) + self.blobs[i][4:HEADER_SIZE]
                + data)

    def _expected(self, i: int) -> tuple:
        x = self._upload(i)
        want = bc3.FAST[bc3_zstd.search(x)[0]]
        return want, bc3.transform(x, want).cpu().numpy().tobytes()

    def control(self, name: str):
        """The reference in the program's place: a call function."""
        picks = {"skip_search": lambda x: bc3.FAST[-1],
                 "ltu_search": lambda x: bc3.FAST[bc3.search(x)[0]]}
        if name not in picks:
            raise ValueError(f"no control {name!r}: {CONTROLS}")

        def call(files):
            batch, results, singles = [], [], []
            for j, i in enumerate(files):
                x = self._upload(i)
                s = picks[name](x)
                data = bc3.transform(x, s).cpu().numpy().tobytes()
                if self.batched[i]:
                    results.append(SimpleNamespace(index=len(batch), transformed=data,
                                                   settings=SimpleNamespace(**s)))
                    batch.append(j)
                else:
                    singles.append((j, self._file_answer(i, s, data)))
            return batch, results, singles
        return call

    def check(self, kept) -> dict:
        """{name: (value, "max" or "min", limit)} over the kept calls' answers.
        ``compared_batch`` and ``compared_per_file`` count the compared answers of
        each route, reported beside ``compared`` (limit 0: a seeded sample may, by
        chance, hold no file of one route)."""
        missing = wrong_settings = wrong_bytes = wrong_header = 0
        by_file = {}
        for files, (batch, results, singles) in kept:
            got = {}
            for r in results:
                k = getattr(r, "index", None)
                if isinstance(k, int) and 0 <= k < len(batch):
                    got.setdefault(batch[k], ("batch", r))
            for j, out in singles:
                got.setdefault(j, ("file", out))
            for j, i in enumerate(files):
                if j in got:
                    by_file.setdefault(i, []).append(got[j])
                else:
                    missing += 1
        compared = {"batch": 0, "file": 0}
        for i, answers in by_file.items():
            want, data = self._expected(i)
            for route, a in answers:
                compared[route] += 1
                if route == "batch":
                    wrong_settings += not _same(a.settings, want)
                    wrong_bytes += a.transformed != data
                    continue
                word = int.from_bytes(a[:4], "little")
                wrong_settings += _settings_of(word) != want
                wrong_bytes += a[HEADER_SIZE:] != data
                wrong_header += (word != bc3.header(want)
                                 or a[4:HEADER_SIZE] != self.blobs[i][4:HEADER_SIZE])
        return {"compared": (compared["batch"] + compared["file"], "min", 1),
                "compared_batch": (compared["batch"], "min", 0),
                "compared_per_file": (compared["file"], "min", 0),
                "missing": (missing, "max", 0),
                "wrong_settings": (wrong_settings, "max", 0),
                "wrong_bytes": (wrong_bytes, "max", 0),
                "wrong_header": (wrong_header, "max", 0)}
