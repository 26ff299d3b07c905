"""Target encoding (twin of reference iop/target.rs, iop/wire.rs).

Targets are encoded as plain ints for cheap hashing in the builder's
dict-based structures and fast numpy conversion at build time:
  * wire(row, column)  ->  row * WIRE_STRIDE + column   (>= 0)
  * virtual(k)         ->  -(k + 1)                     (< 0)
"""

from __future__ import annotations

WIRE_STRIDE = 256  # > num_wires for every supported config


def wire(row: int, column: int) -> int:
    return row * WIRE_STRIDE + column


def virtual(index: int) -> int:
    return -(index + 1)


def is_wire(t: int) -> bool:
    return t >= 0


def wire_row(t: int) -> int:
    return t // WIRE_STRIDE


def wire_column(t: int) -> int:
    return t % WIRE_STRIDE


def virtual_index(t: int) -> int:
    return -t - 1


def is_routable(t: int, num_routed_wires: int) -> bool:
    return t < 0 or wire_column(t) < num_routed_wires
