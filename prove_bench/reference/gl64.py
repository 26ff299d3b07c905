"""Goldilocks field arithmetic on numpy uint64 arrays (plain reference).

A frozen copy of the port's host field module, kept here so that the
benchmark's judge shares no code with the program it judges.

The Goldilocks prime is p = 2^64 - 2^32 + 1.

Values are stored as numpy uint64 and kept *noncanonical* (any u64 represents
its residue mod p); `to_canonical` normalises into [0, p).  This mirrors the
reference semantics (reference: field/src/goldilocks_field.rs:25,346-390).

All operations are fully vectorised and branchless; numpy's wrapping unsigned
arithmetic plays the role of the reference's `wrapping_add`/`overflowing_sub`.
"""

from __future__ import annotations

import numpy as np

# p = 2^64 - 2^32 + 1
ORDER = np.uint64(0xFFFFFFFF00000001)
ORDER_INT = 0xFFFFFFFF00000001
EPSILON = np.uint64(0xFFFFFFFF)  # 2^32 - 1 == 2^64 mod p
MASK32 = np.uint64(0xFFFFFFFF)

TWO_ADICITY = 32
CHARACTERISTIC_TWO_ADICITY = 32
# Smallest generator of the full multiplicative group (reference:
# field/src/goldilocks_field.rs:79).
MULTIPLICATIVE_GROUP_GENERATOR = 7
# Generator of the 2-adic (order 2^32) subgroup (goldilocks_field.rs:86).
POWER_OF_TWO_GENERATOR = 1753635133440165772

_ONE = np.uint64(1)
_U32 = np.uint64(32)


def _wrapping(fn):
    """Wrapping unsigned arithmetic is intentional; numpy warns on scalar
    (0-d) overflow even though arrays wrap silently."""
    def wrapped(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)
    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


def to_canonical(x: np.ndarray) -> np.ndarray:
    """Reduce noncanonical u64 residues into [0, p)."""
    x = np.asarray(x, dtype=np.uint64)
    return np.where(x >= ORDER, x - ORDER, x)


@_wrapping
def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a + b mod p for arbitrary (noncanonical) u64 inputs."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    s = a + b
    carry = s < a
    # 2^64 == EPSILON (mod p); adding EPSILON on carry. The second add can
    # carry again only if s < EPSILON, in which case +EPSILON cannot overflow.
    s2 = s + np.where(carry, EPSILON, np.uint64(0))
    carry2 = carry & (s2 < s)
    return s2 + np.where(carry2, EPSILON, np.uint64(0))


def neg(a: np.ndarray) -> np.ndarray:
    a = to_canonical(a)
    return np.where(a == 0, np.uint64(0), ORDER - a)


@_wrapping
def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a - b mod p for arbitrary u64 inputs."""
    a = np.asarray(a, dtype=np.uint64)
    b = to_canonical(b)
    d = a - b
    borrow = a < b
    # -2^64 == -EPSILON (mod p): subtract EPSILON on borrow.
    d2 = d - np.where(borrow, EPSILON, np.uint64(0))
    borrow2 = borrow & (d2 > d)
    return d2 - np.where(borrow2, EPSILON, np.uint64(0))


@_wrapping
def _mul_wide(a: np.ndarray, b: np.ndarray):
    """Full 64x64 -> 128-bit product as (hi, lo) u64 pair."""
    a0 = a & MASK32
    a1 = a >> _U32
    b0 = b & MASK32
    b1 = b >> _U32
    lolo = a0 * b0
    lohi = a0 * b1
    hilo = a1 * b0
    hihi = a1 * b1
    mid = lohi + (lolo >> _U32)          # cannot overflow
    mid2 = mid + hilo                     # may overflow
    carry = (mid2 < mid).astype(np.uint64)
    lo = (mid2 << _U32) | (lolo & MASK32)
    hi = hihi + (mid2 >> _U32) + (carry << _U32)
    return hi, lo


@_wrapping
def reduce128(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Reduce a 128-bit value (hi*2^64 + lo) mod p.

    Mirrors the identity used by the reference (goldilocks_field.rs:357-381):
      x mod p = lo - hi_hi + hi_lo * EPSILON, with branchless carry fixups.
    """
    hi_hi = hi >> _U32
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    borrow = lo < hi_hi
    t0 = t0 - np.where(borrow, EPSILON, np.uint64(0))
    t1 = hi_lo * EPSILON                  # < 2^64, exact
    t2 = t0 + t1
    carry = t2 < t1
    return t2 + np.where(carry, EPSILON, np.uint64(0))


@_wrapping
def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    hi, lo = _mul_wide(a, b)
    return reduce128(hi, lo)


def square(a: np.ndarray) -> np.ndarray:
    return mul(a, a)


def pow_scalar(base: int, exp: int) -> int:
    """Modular exponentiation on Python ints (host-only, exact)."""
    return pow(base % ORDER_INT, exp, ORDER_INT)


def pow_vec(a: np.ndarray, exp: int) -> np.ndarray:
    """a^exp, vectorised square-and-multiply over a fixed integer exponent."""
    a = np.asarray(a, dtype=np.uint64)
    result = np.ones_like(a)
    acc = a
    e = exp
    while e:
        if e & 1:
            result = mul(result, acc)
        e >>= 1
        if e:
            acc = square(acc)
    return result


def inv(a: np.ndarray) -> np.ndarray:
    """Multiplicative inverse via Fermat (a^(p-2)); a must be nonzero mod p."""
    return pow_vec(a, ORDER_INT - 2)


def batch_inv(a: np.ndarray) -> np.ndarray:
    """Montgomery batch inversion: one field inversion for n elements.

    Mirrors `Field::batch_multiplicative_inverse` (field/src/types.rs).
    Zero entries map to zero (as in the reference's checked variant).
    """
    a = np.asarray(a, dtype=np.uint64)
    flat = to_canonical(a.ravel())
    nz = flat != 0
    vals = np.where(nz, flat, _ONE)
    n = vals.shape[0]
    if n == 0:
        return a.copy()

    # inv(vals[i]) = (prod_{j<i} vals[j]) * (prod_{j>i} vals[j]) * total^-1.
    # Both exclusive prefix/suffix products come from log-depth
    # Hillis-Steele scans (vectorised mul passes) — a sequential Python
    # loop costs ~47 s per 2^20 elements, the scan ~1 s.
    def _excl_scan(v: np.ndarray) -> np.ndarray:
        s = np.empty(n, dtype=np.uint64)
        s[0] = _ONE
        s[1:] = v[:-1]
        shift = 1
        while shift < n:
            s[shift:] = mul(s[shift:], s[:-shift].copy())
            shift *= 2
        return s

    prefix = _excl_scan(vals)
    suffix = _excl_scan(vals[::-1])[::-1]
    total = mul(prefix[-1], vals[-1])
    total_inv = np.uint64(pow(int(total), ORDER_INT - 2, ORDER_INT))
    out = mul(mul(prefix, suffix), total_inv)
    out = np.where(nz, out, np.uint64(0))
    return out.reshape(a.shape)


def primitive_root_of_unity(n_log: int) -> int:
    """Generator of the order-2^n_log subgroup (field/src/types.rs:449)."""
    assert 0 <= n_log <= TWO_ADICITY
    base = POWER_OF_TWO_GENERATOR
    return pow_scalar(base, 1 << (TWO_ADICITY - n_log))



def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as u64 (host, exact).

    Log-doubling (out[m:2m] = out[:m] * base^m): log2(n) vectorised
    passes instead of an O(n) Python-int loop — the difference between
    milliseconds and tens of seconds for the 2^20+ twiddle/subgroup
    tables of the distributed NTT paths."""
    out = np.ones(max(n, 1), dtype=np.uint64)
    base_m = np.uint64(base % ORDER_INT)
    m = 1
    while m < n:
        cnt = min(m, n - m)
        out[m:m + cnt] = mul(out[:cnt], base_m)
        base_m = mul(base_m, base_m)
        m *= 2
    return out[:n]
