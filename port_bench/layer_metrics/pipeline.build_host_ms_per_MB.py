"""Host milliseconds per MB (10^6 bytes) of payload in the batch pipeline's
``assemble`` and ``serialize`` stages, from ``BatchProcessor(timing=True).times``
over a pass after the traced window (the stage timing synchronises the card, so it
cannot run inside it)."""


def read(records: dict):
    stages = records.get("stage_seconds")
    if not stages or not records.get("stage_bytes"):
        return None
    host = stages.get("assemble", 0.0) + stages.get("serialize", 0.0)
    return 1000.0 * host / (records["stage_bytes"] / 1e6) if host else None
