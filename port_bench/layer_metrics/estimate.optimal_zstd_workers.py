"""Mean number of zstd-1 scorer workers compressing while the scorer's span is open:
the workers' microseconds inside ``ZSTD_compress2`` (counter ``zstd.worker_us``)
over the self seconds of the span ``dlt.zstd.estimate``, both over the calls of the
entry's stage pass. None where the program has no such counter."""


def read(records: dict):
    us = (records.get("stage_counters") or {}).get("zstd.worker_us")
    s = (records.get("stage_span_self_s") or {}).get("dlt.zstd.estimate")
    if us is None or not s:
        return None
    return us / 1e6 / s
