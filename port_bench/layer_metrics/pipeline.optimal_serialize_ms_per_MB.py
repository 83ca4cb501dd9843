"""Host milliseconds per MB (10^6 bytes) of the batch route's payload in the
host-scored batch serializer: self seconds of the span ``dlt.batch.serialize`` over
the calls of the entry's stage pass (calls after the traced window, under the
profiler, on the window's schedule)."""


def read(records: dict):
    s = (records.get("stage_span_self_s") or {}).get("dlt.batch.serialize")
    if s is None or not records.get("stage_batch_bytes"):
        return None
    return 1000.0 * s / (records["stage_batch_bytes"] / 1e6)
