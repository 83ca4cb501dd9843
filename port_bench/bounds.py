"""The least time the card could take for the work the traffic needs: the yardstick
of the roofline shares.

Peaks of one NVIDIA H100 SXM at its full 700 W:

- device memory: 3.35 TB/s (NVIDIA's H100 data sheet);
- 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.727 Tops
  (the Hopper architecture whitepaper: 16 INT32 lanes in each of an SM's 4
  partitions; 1.98 GHz is the card's maximum SM clock). A constant with that
  derivation, not read from the card.

A function that moves bytes is bounded by its bytes: each byte of its input read
once and each byte of its output written once. The LTU count is bounded by its
integer operations: 2 per counted position (its gram and the add of its weight) and
2 per gram compare that the data needs (the compare and the select of its weight),
the compares taken in ascending offset order up to the nearest match.
"""

from __future__ import annotations

MEMORY_BYTES_PER_S = 3.35e12
SMS, INT32_LANES_PER_SM, MAX_SM_HZ = 132, 64, 1.98e9
INT_OPS_PER_S = SMS * INT32_LANES_PER_SM * MAX_SM_HZ
OPS_PER_POSITION, OPS_PER_COMPARE = 2, 2


def bytes_seconds(nbytes: float) -> float:
    return nbytes / MEMORY_BYTES_PER_S


def ops_seconds(ops: float) -> float:
    return ops / INT_OPS_PER_S


def count_ops(positions: int, compares: int) -> int:
    return OPS_PER_POSITION * positions + OPS_PER_COMPARE * compares


def regions_bytes(block_size: int, n: int, region_bytes: int) -> int:
    """A region kernel over n blocks: the blocks read, every candidate region
    (``region_bytes`` in all) written."""
    return block_size * n + region_bytes


def transform_bytes(block_size: int, n: int) -> int:
    """A transform or untransform of n blocks: the payload read and written."""
    return 2 * block_size * n
