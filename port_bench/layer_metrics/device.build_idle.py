"""Share of the traced window in which no kernel, copy or memset ran on the card,
in percent."""


def read(records: dict):
    if not records.get("window_s") or not records.get("device_events"):
        return None
    return 100.0 * (1.0 - records["busy_s"] / records["window_s"])
