"""Host milliseconds per MB (10^6 bytes) of payload in the zstd-1 scorer: self
seconds of the span ``dlt.zstd.estimate`` over the calls of the entry's stage pass
(calls after the traced window, under the profiler, on the window's schedule)."""


def read(records: dict):
    s = (records.get("stage_span_self_s") or {}).get("dlt.zstd.estimate")
    if s is None or not records.get("stage_bytes"):
        return None
    return 1000.0 * s / (records["stage_bytes"] / 1e6)
