"""The two PLONK prover helpers that the STARK prover borrows."""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..field.goldilocks import GF, exclusive_scan
from ..fri.oracle import COSET_SHIFT

P = gl64.ORDER_INT


def _exclusive_prefix_product(v: GF) -> GF:
    """[1, v0, v0 v1, ...] along the last axis (log-depth scan)."""
    return GF(exclusive_scan(v.v))


def _z_h_on_coset(degree_bits: int, qdb: int) -> np.ndarray:
    """Z_H(shift * h^i) = shift^n * (h^n)^i - 1, period 2^qdb
    (reference field/src/zero_poly_coset.rs:7)."""
    n = 1 << degree_bits
    shift_pow_n = gl64.pow_scalar(COSET_SHIFT, n)
    h = gl64.primitive_root_of_unity(degree_bits + qdb)
    h_pow_n = gl64.pow_scalar(h, n)  # primitive 2^qdb-th root
    out = np.empty(1 << qdb, dtype=np.uint64)
    acc = shift_pow_n
    for i in range(1 << qdb):
        out[i] = (acc - 1) % P
        acc = (acc * h_pow_n) % P
    return out
