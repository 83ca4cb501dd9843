"""The check that no JAX and nothing of the JAX package is loaded: module names are
compared by their top-level name (the part before the first dot), whole, so that
``dxt_lossless_transform_tpu_torch`` passes and ``dxt_lossless_transform_tpu`` does
not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dxt_lossless_transform_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level name is forbidden, sorted."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def check_loaded(when: str) -> None:
    """Exit with code 3, naming what was found on standard error, when
    ``sys.modules`` holds a forbidden module."""
    found = forbidden(list(sys.modules))
    if found:
        print(f"port_bench: {when}: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
