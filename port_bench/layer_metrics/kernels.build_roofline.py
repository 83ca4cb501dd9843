"""Share of the bound (the least time the card could take for the regions, LTU
counts and winners' transforms that the window's files need; ``bounds.py``) in the
device time of every kernel of the traced window, whatever its name, in percent."""


def read(records: dict):
    if not records.get("kernel_s") or not records.get("bound_s"):
        return None
    return 100.0 * records["bound_s"] / records["kernel_s"]
