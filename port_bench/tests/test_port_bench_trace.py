import pytest

from port_bench import trace
from port_bench.trace import Event


class Raw:
    """A profiler event as the profiler hands it over."""

    def __init__(self, name, act, start, end, device="CPU", annotation=False):
        self._n, self._a, self._s, self._e = name, act, start, end
        self._d, self._u = device, annotation

    def name(self):
        return self._n

    def activity_type(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return f"DeviceType.{self._d}"

    def is_user_annotation(self):
        return self._u


def test_spans_mirrored_on_the_device_are_not_device_work():
    events = trace.from_kineto([
        Raw(trace.WINDOW, "user_annotation", 0, 100, annotation=True),
        Raw(trace.WINDOW, "gpu_user_annotation", 0, 100, "CUDA", True),
        Raw("port_bench.call", "gpu_user_annotation", 10, 90, "CUDA", True),
        Raw("k", "kernel", 20, 30, "CUDA"),
        Raw("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 40, 50, "CUDA"),
        Raw("aten::copy_", "cpu_op", 35, 55),
    ])
    assert [(e.name, e.kind) for e in events] == [
        (trace.WINDOW, "window"), ("k", "kernel"),
        ("Memcpy HtoD (Pinned -> Device)", "memcpy"), ("aten::copy_", "host")]


def test_reduce_counts_busy_union_and_labels_gaps():
    ns = 1_000_000_000
    events = [Event(trace.WINDOW, "window", 0, 10 * ns),
              Event("port_bench.call", "host", 0, 10 * ns),
              Event("a", "kernel", 1 * ns, 3 * ns),
              Event("b", "kernel", 2 * ns, 4 * ns),           # overlaps a
              Event("Memcpy DtoH (Device -> Pinned)", "memcpy", 6 * ns, 7 * ns),
              Event("cudaStreamSynchronize", "host", 4 * ns, 6 * ns),
              Event("late", "kernel", 9 * ns, 12 * ns)]        # cut at the window
    r = trace.reduce(events)
    assert r["window_s"] == 10 and r["busy_s"] == pytest.approx(3 + 1 + 1)
    assert r["kernel_s"] == pytest.approx(2 + 2 + 1) and r["d2h_s"] == 1
    assert r["device_ops"][0] == ["a", 2.0] or r["device_ops"][0] == ["b", 2.0]
    gaps = dict(r["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == 2
    assert gaps[trace.NO_EVENT] == pytest.approx(1 + 2)  # 0-1 s and 7-9 s
