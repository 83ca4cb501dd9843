"""Build traffic: each call is ``BatchProcessor(fmt).process(payloads)`` of the
port's ``parallel/pipeline.py``, the batch route of the CLI's ``medium`` preset
(FAST candidates scored by LTU on the card, ``max_batch`` files a device batch), on
the texture payloads of one stream window.

Checked: each answer's settings against the reference's search (the first candidate
of least exact LTU score, the batch step's rule) and its bytes against the
reference's transform under those settings. The system's arithmetic is exact
integer work (the scores and the bytes), with no lower precision to step down to,
so the control breaks the guarantee the search gives: ``skip_search``, the
reference in the program's place, ships every file under the FAST list's last
candidate, the likely winner, as a program that dropped the search would.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import torch

from port_bench import bounds, pool as pool_lib
from port_bench.reference import common

CONTROLS = ("skip_search",)


def _settings_match(program_settings, ref: dict) -> bool:
    try:
        return all(int(getattr(program_settings, k)) == int(v) for k, v in ref.items())
    except (AttributeError, TypeError, ValueError):
        return False


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device,
                 trace: bool):
        self.config, self.mix, self.seed, self.device, self.trace = \
            config, mix, seed, device, trace
        self.ref = importlib.import_module(f"port_bench.reference.{config['format']}")
        self.pool = []
        self.proc = None
        self.bound_s = []

    # --- set-up -------------------------------------------------------------------
    def make_pool(self) -> None:
        self.pool = pool_lib.make_pool(self.config, self.seed, self.device,
                                       keep_device=self.trace)
        self.sizes = [len(f.payload) for f in self.pool]

    def reference_setup(self) -> None:
        """In the traced run, each pool file's bound: its distinct regions built,
        counted, and the winner transformed."""
        if not self.trace:
            return
        bs = self.ref.BLOCK_SIZE
        for f in self.pool:
            secs = self.ref.sections(f.extra.pop("device"))
            positions = sum(max(0, v - 3) for _, v in secs)
            compares = sum(common.compares_needed(r, v) for r, v in secs)
            nbytes = (bounds.regions_bytes(bs, f.blocks, sum(v for _, v in secs))
                      + bounds.transform_bytes(bs, f.blocks))
            self.bound_s.append(bounds.bytes_seconds(nbytes)
                                + bounds.ops_seconds(bounds.count_ops(positions, compares)))

    def program_setup(self) -> None:
        from dxt_lossless_transform_tpu_torch.parallel.pipeline import BatchProcessor

        self.proc = BatchProcessor(self.config["format"], max_batch=int(self.mix["max_batch"]),
                                   device=self.device)

    def warmup_calls(self, calls) -> list:
        """One call holding one file of each size, then the stream's first
        ``warmup_calls`` calls, so that the pinned host buffers the window's batches
        need are allocated before it."""
        first = {}
        for i, f in enumerate(self.pool):
            first.setdefault(f.size, i)
        return [list(first.values())] + [next(calls)
                                         for _ in range(int(self.mix["warmup_calls"]))]

    # --- the timed path ---------------------------------------------------------------
    def call(self, files):
        return self.proc.process([self.pool[i].payload for i in files])

    def call_bytes(self, files) -> int:
        return sum(self.sizes[i] for i in files)

    def answer_bytes(self, answers) -> int:
        return sum(len(r.transformed) for r in answers)

    def release(self) -> None:
        self.proc = None

    # --- traced run ---------------------------------------------------------------
    def bound_seconds(self, files) -> float:
        return sum(self.bound_s[i] for i in files)

    def stage_pass(self, calls, n_calls: int) -> dict:
        """``BatchProcessor(timing=True)`` over ``n_calls`` more calls: its stage
        seconds (each stage synchronised, so the batches do not overlap)."""
        from dxt_lossless_transform_tpu_torch.parallel.pipeline import BatchProcessor

        proc = BatchProcessor(self.config["format"], max_batch=int(self.mix["max_batch"]),
                              device=self.device, timing=True)
        nbytes = 0
        for _ in range(n_calls):
            files = next(calls)
            proc.process([self.pool[i].payload for i in files])
            nbytes += self.call_bytes(files)
        return {"stage_seconds": dict(proc.times.seconds), "stage_bytes": nbytes}

    # --- the reference, after the window ----------------------------------------------
    def _upload(self, i: int) -> torch.Tensor:
        return torch.frombuffer(bytearray(self.pool[i].payload), dtype=torch.uint8).to(self.device)

    def _expected(self, i: int) -> tuple:
        x = self._upload(i)
        best, _ = self.ref.search(x)
        want = self.ref.FAST[best]
        return want, self.ref.transform(x, want).cpu().numpy().tobytes()

    def control(self, name: str):
        """The reference in the program's place: a call function."""
        if name not in CONTROLS:
            raise ValueError(f"no control {name!r}: {CONTROLS}")

        def call(files):
            out = []
            for j, i in enumerate(files):
                s = self.ref.FAST[-1]
                data = self.ref.transform(self._upload(i), s).cpu().numpy().tobytes()
                out.append(SimpleNamespace(index=j, transformed=data,
                                           settings=SimpleNamespace(**s)))
            return out
        return call

    def check(self, kept) -> dict:
        """{name: (value, "max" or "min", limit)} over the kept calls' answers."""
        missing = wrong_settings = wrong_bytes = 0
        by_file = {}
        for files, answers in kept:
            got = {}
            for r in answers or []:
                got.setdefault(getattr(r, "index", None), r)
            for j, i in enumerate(files):
                r = got.get(j)
                if r is None:
                    missing += 1
                else:
                    by_file.setdefault(i, []).append(r)
        compared = 0
        for i, answers in by_file.items():
            want, data = self._expected(i)
            for r in answers:
                compared += 1
                wrong_settings += not _settings_match(r.settings, want)
                wrong_bytes += r.transformed != data
        return {"compared": (compared, "min", 1), "missing": (missing, "max", 0),
                "wrong_settings": (wrong_settings, "max", 0),
                "wrong_bytes": (wrong_bytes, "max", 0)}
