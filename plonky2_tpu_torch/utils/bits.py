"""Bit/array utilities (twin of reference util/src/lib.rs).

Index permutations (bit-reversal) are precomputed host-side as numpy arrays
and applied on device with gathers / blocked transposes, instead of the
reference's in-place swap loops (util/src/lib.rs:188).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def log2_strict(n: int) -> int:
    """log2 of a power of two; raises otherwise (util/src/lib.rs:35)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{n} is not a positive power of two")
    return n.bit_length() - 1


def log2_ceil(n: int) -> int:
    return (n - 1).bit_length() if n > 1 else 0


@lru_cache(maxsize=64)
def reverse_index_bits_perm(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reverse of i over log2(n) bits."""
    bits = log2_strict(n)
    if bits == 0:
        return np.zeros(1, dtype=np.int32)
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.astype(np.int32)


def reverse_bits(x: int, bits: int) -> int:
    return int(f"{x:0{bits}b}"[::-1], 2) if bits > 0 else 0


def reverse_index_bits(arr: np.ndarray, axis: int = -1) -> np.ndarray:
    """Apply the bit-reversal permutation along an axis (host numpy)."""
    n = arr.shape[axis]
    return np.take(arr, reverse_index_bits_perm(n), axis=axis)


def reverse_index_bits_list(items: list) -> list:
    """Bit-reversal permutation of a python list (e.g. of circuit targets)."""
    perm = reverse_index_bits_perm(len(items))
    return [items[i] for i in perm]
