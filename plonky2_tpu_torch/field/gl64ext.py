"""Host-side GF(p^2) arithmetic on numpy (..., 2) uint64 arrays.

Twin of `extension.GF2` for host logic (verifier, challenger, FRI query
checks).  Layout: x[..., 0] + x[..., 1] * phi with phi^2 = W = 7.
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


def flatten(x):
    """GF(p^2) array (..., 2) -> base-field array (..., 2*last) by component
    interleave; mirrors reference extension `flatten` (extension/mod.rs:128)."""
    return x.reshape(x.shape[:-2] + (-1,)) if x.ndim >= 2 else x


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

    @staticmethod
    def from_base_int(a: int) -> "E2":
        return E2.of(a % gl64.ORDER_INT)

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

    def square(self) -> "E2":
        return E2(square(self.v))

    def mul_small(self, c: int) -> "E2":
        return E2(scalar_mul(self.v, np.uint64(c)))

    def inv(self) -> "E2":
        return E2(inv(self.v))

    def pow_const(self, e: int) -> "E2":
        return E2(pow_int(self.v, e))

    def is_zero(self) -> bool:
        return bool(is_zero(self.v))

    def equals(self, o) -> bool:
        return bool(equal(self.v, _coerce(o)))


def _coerce(o):
    if isinstance(o, E2):
        return o.v
    if isinstance(o, (int,)):
        return make(np.uint64(o % gl64.ORDER_INT), 0)
    return np.asarray(o, dtype=np.uint64)


class V64:
    """Operator-friendly wrapper over base-field u64 numpy arrays.

    The witness-generation twin of E2: generic gate code (e.g. the Poseidon
    round schedule) runs on V64-wrapped arrays vectorised over gate rows.
    """

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = np.asarray(v, dtype=np.uint64)

    @staticmethod
    def of(x) -> "V64":
        return V64(np.asarray(x, dtype=np.uint64))

    def _c(self, o):
        return o.v if isinstance(o, V64) else np.uint64(int(o) % gl64.ORDER_INT)

    def __add__(self, o):
        return V64(gl64.add(self.v, self._c(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return V64(gl64.sub(self.v, self._c(o)))

    def __rsub__(self, o):
        return V64(gl64.sub(self._c(o), self.v))

    def __mul__(self, o):
        return V64(gl64.mul(self.v, self._c(o)))

    __rmul__ = __mul__

    def __neg__(self):
        return V64(gl64.neg(self.v))

    def square(self) -> "V64":
        return V64(gl64.square(self.v))

    def mul_small(self, c: int) -> "V64":
        return V64(gl64.mul(self.v, np.uint64(c)))


class V64Ctx:
    ext = False

    def constant(self, v: int):
        return V64.of(np.uint64(v % gl64.ORDER_INT))

    def zero(self):
        return self.constant(0)

    def one(self):
        return self.constant(1)


class I64:
    """Python-int twin of V64 for SINGLE witness rows.

    numpy's per-op overhead (~µs each, plus the errstate context managers
    in gl64's wrapped ops) makes V64 ~1000x slower than plain python ints
    at batch size 1 — and sequential generator chains (e.g. the
    public-input hash sponge) level into single-row groups, which made
    Poseidon witness generation the dominant cost of plonk proving
    (BASELINE.md round 5: 321 s of a 537 s matmul prove)."""

    __slots__ = ("v",)
    _P = gl64.ORDER_INT

    def __init__(self, v: int):
        self.v = v % self._P

    def _c(self, o):
        return o.v if isinstance(o, I64) else int(o) % self._P

    def __add__(self, o):
        return I64(self.v + self._c(o))

    __radd__ = __add__

    def __sub__(self, o):
        return I64(self.v - self._c(o))

    def __rsub__(self, o):
        return I64(self._c(o) - self.v)

    def __mul__(self, o):
        return I64(self.v * self._c(o))

    __rmul__ = __mul__


class I64Ctx:
    ext = False

    def constant(self, v: int):
        return I64(int(v))

    def zero(self):
        return I64(0)

    def one(self):
        return I64(1)
