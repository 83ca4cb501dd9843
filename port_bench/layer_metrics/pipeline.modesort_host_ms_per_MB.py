"""Host milliseconds per MB (10^6 bytes) of payload in the mode-sort batch's two host
copies: the self seconds of the spans ``dlt.modesort.assemble`` (the payloads into
the pinned rows) and ``dlt.modesort.winners`` (the winners' bytes out of the
downloaded rows) over the calls of the entry's stage pass. None where the program has
no ``winners`` span."""


def read(records: dict):
    self_s = records.get("stage_span_self_s") or {}
    names = ("dlt.modesort.assemble", "dlt.modesort.winners")
    if any(n not in self_s for n in names) or not records.get("stage_bytes"):
        return None
    return 1000.0 * sum(self_s[n] for n in names) / (records["stage_bytes"] / 1e6)
