"""Share of the bound (the least time the card could take for the window's work under
the optimal preset: each payload read by the region kernel, its distinct regions
written, with the index streams on the batch route and the winner's transform on the
per-file route; ``entries/optimal_transform.py``, ``bounds.py``) in the device time
of every kernel of the traced window, whatever its name, in percent."""


def read(records: dict):
    if not records.get("kernel_s") or not records.get("bound_s"):
        return None
    return 100.0 * records["bound_s"] / records["kernel_s"]
