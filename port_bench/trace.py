"""The traced run's reading of the card: a ``torch.profiler`` window, kept in memory,
reduced to the records the per-layer metrics read.

Device events are kernels, copies (``Memcpy HtoD``/``DtoH``/``DtoD``) and memsets.
The window is the harness's ``port_bench.window`` span; busy time is the union of
the device events inside it, and each idle gap is put down to what the host was
doing at its middle: the innermost host event (an operator or a runtime call) that
covers it, or :data:`NO_EVENT` (Python and numpy work between operators).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, List

HARNESS = "port_bench."
WINDOW = HARNESS + "window"
NO_EVENT = "host: Python or numpy (no profiled operator)"
_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_SCAN = 256  # host events looked at backwards from a gap's middle


@dataclass
class Event:
    name: str
    kind: str        # kernel, memcpy, memset, host, window
    start: int       # ns
    end: int         # ns


def from_kineto(raw) -> List[Event]:
    """The profiler's events as :class:`Event` records. Spans the harness or the
    program open are host events only: their copies on the device's timeline
    (user annotations) are left out."""
    out = []
    for e in raw:
        act = str(getattr(e, "activity_type", lambda: "")())
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        annotation = (getattr(e, "is_user_annotation", lambda: False)()
                      or "user_annotation" in act)
        if on_device and annotation:
            continue
        if name == WINDOW and not on_device:
            out.append(Event(name, "window", start, end))
        elif act in _DEVICE_KINDS:
            out.append(Event(name, _DEVICE_KINDS[act], start, end))
        elif on_device:
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
            out.append(Event(name, kind, start, end))
        else:
            out.append(Event(name, "host", start, end))
    return out


def profile(fn: Callable[[], object], device) -> tuple:
    """``fn()`` under the profiler (host and, on a CUDA device, the card), in the
    window span; -> (its result, the events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return out, from_kineto(prof.profiler.kineto_results.events())


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: List[Event]) -> dict:
    """Device seconds by kind and name, busy and window seconds, the device
    operations that took most time and the idle gaps by what the host did."""
    win = [e for e in events if e.kind == "window"]
    if not win:
        raise ValueError("no window span in the trace")
    ws, we = win[0].start, win[0].end
    dev = [e for e in events if e.kind in ("kernel", "memcpy", "memset")
           and e.end > ws and e.start < we]
    seconds = defaultdict(float)
    by_name = defaultdict(float)
    for e in dev:
        d = (min(e.end, we) - max(e.start, ws)) / 1e9
        key = e.kind
        if e.kind == "memcpy":
            key = ("h2d" if "HtoD" in e.name else "d2h" if "DtoH" in e.name else "d2d")
        seconds[key] += d
        by_name[e.name] += d
    busy = _union([(max(e.start, ws), min(e.end, we)) for e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps, prev = [], ws
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if we > prev:
        gaps.append((prev, we))
    host = sorted((e for e in events if e.kind == "host"), key=lambda e: e.start)
    starts = [e.start for e in host]
    idle = defaultdict(float)
    for s, e in gaps:
        idle[_host_label(host, starts, (s + e) // 2)] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (we - ws) / 1e9, "busy_s": busy_s,
            "kernel_s": seconds["kernel"], "h2d_s": seconds["h2d"],
            "d2h_s": seconds["d2h"], "d2d_s": seconds["d2d"],
            "memset_s": seconds["memset"], "device_events": len(dev),
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def _host_label(host: List[Event], starts: List[int], t: int) -> str:
    """The innermost host event covering time ``t``, the harness's own spans aside."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _SCAN), -1):
        if host[j].end >= t and not host[j].name.startswith(HARNESS):
            return host[j].name
    return NO_EVENT
