"""Profiling hooks (counterpart of ``dxt_lossless_transform_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace of a region, the card's kernels
included when the device is a CUDA one, and writes it as a Chrome trace (viewable in
Perfetto or ``chrome://tracing``); the CLI's ``--profile DIR`` wraps a whole command
in it. :func:`span` names a region of the program inside such a trace (the batch
processors' stages, the wait on the card, the DDS handler's steps, all ``dlt.*``), as
a ``torch.profiler.record_function``, so that its host events share the profiler's
clock with the card's kernels and copies. While no profiler records, a span is one
check of a flag and a shared null context.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Union

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(out_dir: Optional[str],
          device: Union[str, torch.device] = "cuda") -> Iterator[None]:
    """Record a profiler trace into ``out_dir`` (no-op when None): CPU activity, and
    CUDA activity when ``device`` is a CUDA device. The trace is written when the
    region ends, as ``trace-<pid>-<ns>.json``."""
    if not out_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        out_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def span(name: str, args: Optional[str] = None):
    """A named region of the program in the timeline of a recording profiler, with
    ``args`` beside it; while none records, a context that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name, args)


#: The JAX package's name for :func:`span`.
annotate = span
