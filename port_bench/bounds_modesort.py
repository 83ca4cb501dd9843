"""The least time the card could take for the BC7/BC6H mode-sort batch's search of
one file: the yardstick that ``kernels.build_roofline`` reads in the BC7 cell, on the
peaks and the count of :mod:`.bounds`, unchanged.

For a file of n blocks and its FAST candidates' distinct ``(sort, planes)`` rows:

- each row: the payload read once by its transform (the identity's by its copy) and
  the row written once, 16n bytes, or 16n + ceil(n/2) when sorted (the mode stream);
- the count: each row read once, with :func:`.bounds.count_ops` over its positions
  (valid - 3) and the gram compares its data needs;
- the winner's gather: the LTU pick's row read and written once.

Every byte is charged at the memory peak and every operation at the integer peak, one
after the other.
"""

from __future__ import annotations

from typing import Sequence

from port_bench import bounds

BLOCK_SIZE = 16


def row_len(n: int, sort: bool) -> int:
    """Bytes of a candidate's whole stream over n blocks."""
    return BLOCK_SIZE * n + ((n + 1) // 2 if sort else 0)


def file_bytes(n: int, sorts: Sequence[bool], winner_sort: bool) -> int:
    """Bytes the file's rows, its count and its gather move: ``sorts`` gives each
    distinct row's sort flag."""
    rows = [row_len(n, s) for s in sorts]
    return (sum(BLOCK_SIZE * n + r for r in rows) + sum(rows)
            + 2 * row_len(n, winner_sort))


def file_ops(n: int, sorts: Sequence[bool], compares: int) -> int:
    """The count's integer operations over the rows, ``compares`` the gram compares
    of all of them."""
    positions = sum(max(0, row_len(n, s) - 3) for s in sorts)
    return bounds.count_ops(positions, compares)


def file_seconds(n: int, sorts: Sequence[bool], compares: int,
                 winner_sort: bool) -> float:
    return (bounds.bytes_seconds(file_bytes(n, sorts, winner_sort))
            + bounds.ops_seconds(file_ops(n, sorts, compares)))
