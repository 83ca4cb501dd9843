"""Profiling hooks (counterpart of ``dxt_lossless_transform_tpu/utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace of a region, the card's kernels
included when the device is a CUDA one, and writes it as a Chrome trace (viewable in
Perfetto or ``chrome://tracing``); the CLI's ``--profile DIR`` wraps a whole command
in it. :func:`annotate` names a sub-region inside a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Union

import torch


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


def annotate(name: str):
    """Named sub-region inside a trace (shows up in the timeline)."""
    return torch.profiler.record_function(name)
