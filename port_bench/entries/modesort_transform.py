"""Build traffic of the mode-sort batch: each call is
``ModeSortBatchProcessor("bc7", max_batch).process(payloads)`` of the port's
``parallel/pipeline.py``, the ``medium`` preset's batch route for BC7, on the texture
payloads of one stream window: every file's four FAST candidate streams written on
the card into rows of two lengths (sorted rows carry the mode stream), scored by one
LTU count, the winners downloaded, and the zstd-1 identity guard of each winner that
is not the identity against its payload on the host's scorer pool. The library call
takes every payload, 4096² chains included; the CLI's 8 MiB per-file cut for BC7
(``cli.main._BATCH_MODESORT_MAX_BYTES``) is its own policy and is not applied.

Checked: each answer's settings against the reference's search and guard
(``reference/bc7.py``: the first candidate of least exact LTU score over its whole
stream, the identity where that pick's zstd-1 size is not strictly below the
payload's) and its bytes against the reference's transform under those settings.
``guarded`` and ``reverted`` count the compared answers whose pick the guard checked
and those it turned to the identity. The work is exact integer work and exact
compressed sizes, with no lower precision to step down to, so the controls break the
guarantees, with the reference in the program's place: ``skip_search`` ships every
file under the FAST list's last candidate, as a program that dropped the search
would; ``skip_guard`` ships the LTU pick, as a program that dropped the guard would.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from port_bench import bounds_modesort, pool_bc7, spans, trace as trace_lib
from port_bench.reference import bc7, common

CONTROLS = ("skip_search", "skip_guard")


def _same(program_settings, ref: dict) -> bool:
    try:
        return all(bool(getattr(program_settings, k)) == v for k, v in ref.items())
    except (AttributeError, TypeError, ValueError):
        return False


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device,
                 trace: bool):
        if config["format"] != "bc7":
            raise ValueError(f"modesort_transform runs BC7, not {config['format']!r}")
        self.config, self.mix, self.seed, self.device, self.trace = \
            config, mix, seed, device, trace
        self.pool = []
        self.proc = None
        self.bound_s = []

    # --- set-up -------------------------------------------------------------------
    def make_pool(self) -> None:
        self.pool = pool_bc7.make_pool(self.config, self.seed, self.device,
                                       keep_device=self.trace)
        self.sizes = [len(f.payload) for f in self.pool]

    def reference_setup(self) -> None:
        """In the traced run, each pool file's bound (``bounds_modesort``): its four
        rows written and counted, with the compares their data needs, and its LTU
        pick's row gathered."""
        if not self.trace:
            return
        sorts = [c["sort_by_mode"] for c in bc7.FAST]
        for f in self.pool:
            x = f.extra.pop("device")
            scores, compares = [], 0
            for c in bc7.FAST:
                row = bc7.transform(x, c)
                w, cmp = common.nearest_match(row, row.numel())
                scores.append(common.WEIGHT_SCALE * row.numel() - int(w.sum())
                              + common.entropy_term(row, row.numel()))
                compares += int(cmp.sum())
            pick = scores.index(min(scores))
            self.bound_s.append(bounds_modesort.file_seconds(
                f.blocks, sorts, compares, bc7.FAST[pick]["sort_by_mode"]))

    def program_setup(self) -> None:
        from dxt_lossless_transform_tpu_torch.parallel.pipeline import ModeSortBatchProcessor

        self.proc = ModeSortBatchProcessor(self.config["format"],
                                           max_batch=int(self.mix["max_batch"]),
                                           device=self.device)

    def warmup_calls(self, calls) -> list:
        """One call holding one file of each size, then the stream's first
        ``warmup_calls`` calls, so that the pinned host buffers and the scorer pool
        the window's batches need are made before it."""
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
        """``n_calls`` more calls under the profiler, each call's answers held until
        the next returns, as the window holds them: the program's spans' self
        seconds (``spans.reduce``), the counters' change, and the calls' payload
        bytes. The profiler is opened here, not through
        ``trace.profile``, which ``spans.traced_run`` replaces to take the window's
        records."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from dxt_lossless_transform_tpu_torch import backend

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        nbytes = 0
        held = None
        before = backend.counters()
        with profile(activities=acts) as prof:
            with record_function(trace_lib.WINDOW):
                for _ in range(n_calls):
                    files = next(calls)
                    held = self.call(files)
                    nbytes += self.call_bytes(files)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        del held
        events = trace_lib.from_kineto(prof.profiler.kineto_results.events())
        rec = spans.reduce(events, before, backend.counters())
        return {"stage_span_self_s": rec["span_self_s"],
                "stage_counters": rec["counters"], "stage_bytes": nbytes}

    # --- the reference, after the window ----------------------------------------------
    def _upload(self, i: int) -> torch.Tensor:
        return torch.frombuffer(bytearray(self.pool[i].payload),
                                dtype=torch.uint8).to(self.device)

    def _expected(self, i: int) -> tuple:
        """(the LTU pick, the index that ships, the shipped bytes) of pool file i."""
        x = self._upload(i)
        pick, ship = bc7.shipped(x)
        return pick, ship, bc7.transform(x, bc7.FAST[ship]).cpu().numpy().tobytes()

    def control(self, name: str):
        """The reference in the program's place: a call function."""
        picks = {"skip_search": lambda x: len(bc7.FAST) - 1,
                 "skip_guard": lambda x: bc7.search(x)[0]}
        if name not in picks:
            raise ValueError(f"no control {name!r}: {CONTROLS}")

        def call(files):
            out = []
            for j, i in enumerate(files):
                x = self._upload(i)
                s = bc7.FAST[picks[name](x)]
                out.append(SimpleNamespace(
                    index=j, transformed=bc7.transform(x, s).cpu().numpy().tobytes(),
                    settings=SimpleNamespace(**s)))
            return out
        return call

    def check(self, kept) -> dict:
        """{name: (value, "max" or "min", limit)} over the kept calls' answers.
        ``guarded`` and ``reverted`` are reported beside them (limit 0: a seeded
        sample may, by chance, hold neither)."""
        missing = wrong_settings = wrong_bytes = guarded = reverted = 0
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
            pick, ship, data = self._expected(i)
            for r in answers:
                compared += 1
                guarded += bc7.FAST[pick] != bc7.IDENTITY
                reverted += ship != pick
                wrong_settings += not _same(r.settings, bc7.FAST[ship])
                wrong_bytes += r.transformed != data
        return {"compared": (compared, "min", 1), "missing": (missing, "max", 0),
                "wrong_settings": (wrong_settings, "max", 0),
                "wrong_bytes": (wrong_bytes, "max", 0),
                "guarded": (guarded, "min", 0), "reverted": (reverted, "min", 0)}
