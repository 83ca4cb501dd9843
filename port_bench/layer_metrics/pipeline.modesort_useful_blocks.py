"""Share of the blocks the mode-sort batch launched that are payload, in percent:
100 times the change of the counter ``modesort.blocks_real`` over that of
``modesort.blocks_launched`` (each batch's rows, a bucket of blocks each) over the
calls of the entry's stage pass. None where the program has no such counters."""


def read(records: dict):
    counts = records.get("stage_counters") or {}
    real, launched = counts.get("modesort.blocks_real"), counts.get("modesort.blocks_launched")
    if real is None or not launched:
        return None
    return 100.0 * real / launched
