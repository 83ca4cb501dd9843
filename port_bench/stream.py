"""The one general generator of calls: it reads a traffic mix's parameters and turns
the pool into the endless sequence of calls a closed-loop caller makes.

A mix (``traffic/<name>.json``) holds:

- ``entry``: the kind of call, the name of a module in ``entries/``;
- ``order``: ``"passes"``, the pool in a new seeded order on every pass, the passes
  one after another, so that every stretch of a pool's length holds every file once;
- ``cut``: ``{"bytes": B}`` to give each call the next files until their bytes
  reach B (the last file may take a call past B, as the CLI cuts its stream
  windows), or ``{"files": k}`` for k files a call;
- ``check_share``, ``check_bytes``: the share of calls, drawn from the seed, whose
  answers are kept and compared after the window, and the most bytes of answers
  kept;
- entry-specific parameters (``max_batch``, ``warmup_calls``, ...).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence

import numpy as np

# the purposes of the seeded generators, so that each draws its own numbers
POOL, ORDER, CHECK = 1, 2, 3


def rng(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, purpose])


def order(n_files: int, seed: int) -> Iterator[int]:
    """Pool indices, pass after pass, each pass a new seeded permutation."""
    r = rng(seed, ORDER)
    while True:
        yield from (int(i) for i in r.permutation(n_files))


def calls(sizes: Sequence[int], mix: dict, seed: int) -> Iterator[List[int]]:
    """The calls (lists of pool indices) of ``mix`` over files of ``sizes`` bytes."""
    if mix.get("order", "passes") != "passes":
        raise ValueError(f"unknown order {mix['order']!r}")
    cut = mix["cut"]
    files = order(len(sizes), seed)
    while True:
        if "files" in cut:
            yield [next(files) for _ in range(int(cut["files"]))]
            continue
        call, acc = [], 0
        while acc < int(cut["bytes"]):
            i = next(files)
            call.append(i)
            acc += sizes[i]
        yield call


def keeper(mix: dict, seed: int) -> Callable[[int], bool]:
    """``keep(nbytes)``: whether the next call's answers are kept for the check: the
    window's first call, then each by a seeded draw, until ``check_bytes`` of
    answers are kept."""
    r = rng(seed, CHECK)
    share, room, first = float(mix["check_share"]), [int(mix["check_bytes"])], [True]

    def keep(nbytes: int) -> bool:
        drawn = r.random() < share or first[0]
        first[0] = False
        if not drawn or nbytes > room[0]:
            return False
        room[0] -= nbytes
        return True
    return keep
