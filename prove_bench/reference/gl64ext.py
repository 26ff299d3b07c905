"""GF(p^2) arithmetic on numpy (..., 2) uint64 arrays (plain reference,
a frozen copy of the port's host extension field).

Layout: x[..., 0] + x[..., 1] * phi with phi^2 = W = 7.
"""

from __future__ import annotations

import numpy as np

from . import gl64

W = 7


def make(a, b=0) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    b = np.broadcast_to(np.asarray(b, dtype=np.uint64), a.shape)
    return np.stack([a, b], axis=-1)


def from_base(a) -> np.ndarray:
    return make(a, np.zeros_like(np.asarray(a, dtype=np.uint64)))


ZERO = make(0, 0)
ONE = make(1, 0)


def add(x, y):
    return np.stack(
        [gl64.add(x[..., 0], y[..., 0]), gl64.add(x[..., 1], y[..., 1])], axis=-1
    )


def sub(x, y):
    return np.stack(
        [gl64.sub(x[..., 0], y[..., 0]), gl64.sub(x[..., 1], y[..., 1])], axis=-1
    )


def neg(x):
    return np.stack([gl64.neg(x[..., 0]), gl64.neg(x[..., 1])], axis=-1)


def mul(x, y):
    a0, b0 = x[..., 0], x[..., 1]
    a1, b1 = y[..., 0], y[..., 1]
    ra = gl64.add(gl64.mul(a0, a1), gl64.mul(gl64.mul(b0, b1), np.uint64(W)))
    rb = gl64.add(gl64.mul(a0, b1), gl64.mul(b0, a1))
    return np.stack([ra, rb], axis=-1)


def scalar_mul(x, s):
    s = np.asarray(s, dtype=np.uint64)
    return np.stack([gl64.mul(x[..., 0], s), gl64.mul(x[..., 1], s)], axis=-1)


def square(x):
    return mul(x, x)


def inv(x):
    a, b = x[..., 0], x[..., 1]
    norm = gl64.sub(gl64.mul(a, a), gl64.mul(gl64.mul(b, b), np.uint64(W)))
    ninv = gl64.inv(norm)
    return np.stack([gl64.mul(a, ninv), gl64.neg(gl64.mul(b, ninv))], axis=-1)


def pow_int(x, e: int):
    result = np.broadcast_to(ONE, x.shape).copy()
    acc = x
    while e:
        if e & 1:
            result = mul(result, acc)
        e >>= 1
        if e:
            acc = square(acc)
    return result


def to_canonical(x):
    return np.stack([gl64.to_canonical(x[..., 0]), gl64.to_canonical(x[..., 1])], axis=-1)


def equal(x, y):
    return np.all(to_canonical(x) == to_canonical(y), axis=-1)


def is_zero(x):
    return np.all(to_canonical(x) == 0, axis=-1)


def total(x):
    """Sum of an (n, 2) array of extension elements -> (2,), by pairwise
    halving (one vectorised add per level)."""
    x = np.asarray(x, dtype=np.uint64).reshape(-1, 2)
    if x.shape[0] == 0:
        return ZERO.copy()
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = np.concatenate([x, ZERO[None]], axis=0)
        x = add(x[0::2], x[1::2])
    return x[0]


def powers(base, n: int):
    """[1, base, ..., base^(n-1)], shape (n, 2), by doubling: a table of
    length k extends to 2k via table * base^k (vectorised)."""
    out = ONE[None].copy()
    bk = np.asarray(base, dtype=np.uint64).reshape(2)
    while out.shape[0] < n:
        out = np.concatenate([out, mul(out, bk)], axis=0)
        bk = square(bk)
    return out[:n]



class E2:
    """Operator-friendly scalar wrapper over a (2,) u64 extension element.

    Lets generic (field-polymorphic) code — gate constraint evaluators, the
    vanishing polynomial — run unchanged on host extension scalars, device
    GF/GF2 arrays, or (later) circuit targets.
    """

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = np.asarray(v, dtype=np.uint64).reshape(2)

    @staticmethod
    def of(a, b=0) -> "E2":
        return E2(np.array([a, b], dtype=np.uint64))

    def __add__(self, o):
        return E2(add(self.v, _coerce(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return E2(sub(self.v, _coerce(o)))

    def __rsub__(self, o):
        return E2(sub(_coerce(o), self.v))

    def __mul__(self, o):
        return E2(mul(self.v, _coerce(o)))

    __rmul__ = __mul__

    def __neg__(self):
        return E2(neg(self.v))

    def inv(self) -> "E2":
        return E2(inv(self.v))

    def pow_const(self, e: int) -> "E2":
        return E2(pow_int(self.v, e))

    def equals(self, o) -> bool:
        return bool(equal(self.v, _coerce(o)))


def _coerce(o):
    if isinstance(o, E2):
        return o.v
    if isinstance(o, (int,)):
        return make(np.uint64(o % gl64.ORDER_INT), 0)
    return np.asarray(o, dtype=np.uint64)
