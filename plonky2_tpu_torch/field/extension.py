"""Quadratic extension GF(p^2) = GF(p)[X]/(X^2 - 7) on torch, D = 2.

Twin of the reference's quadratic Goldilocks extension (reference:
field/src/extension/quadratic.rs, field/src/goldilocks_extensions.rs:14 with
W = 7).  Elements are pairs (a, b) = a + b*phi with phi^2 = W, each
component a base-field ``GF``.  NTT twiddles live in the base field, so
extension codewords transform componentwise; only challenge folds need
extension multiplies.
"""

from __future__ import annotations

import numpy as np

from .goldilocks import GF

W = 7


class GF2:
    """Array of GF(p^2) elements: a + b*phi, phi^2 = 7."""

    __slots__ = ("a", "b")

    def __init__(self, a: GF, b: GF):
        self.a = a
        self.b = b

    # -- construction --------------------------------------------------
    @classmethod
    def from_base(cls, x: GF) -> "GF2":
        return cls(x, GF.zeros(x.shape, x.device))

    @classmethod
    def from_u64_pair(cls, a, b, device) -> "GF2":
        return cls(GF.from_u64(a, device), GF.from_u64(b, device))

    @classmethod
    def ones(cls, shape, device) -> "GF2":
        return cls(GF.ones(shape, device), GF.zeros(shape, device))

    @classmethod
    def full(cls, shape, a: int, b: int, device) -> "GF2":
        return cls(GF.full(shape, a, device), GF.full(shape, b, device))

    def to_u64(self) -> np.ndarray:
        """(..., 2) numpy array of canonical u64 components [a, b]."""
        return np.stack([self.a.to_u64(), self.b.to_u64()], axis=-1)

    # -- shape ----------------------------------------------------------
    @property
    def shape(self):
        return self.a.shape

    @property
    def device(self):
        return self.a.device

    def reshape(self, *shape) -> "GF2":
        return GF2(self.a.reshape(*shape), self.b.reshape(*shape))

    def __getitem__(self, idx) -> "GF2":
        return GF2(self.a[idx], self.b[idx])

    def take(self, indices, axis: int = 0) -> "GF2":
        return GF2(self.a.take(indices, axis), self.b.take(indices, axis))

    def broadcast_to(self, shape) -> "GF2":
        return GF2(self.a.broadcast_to(shape), self.b.broadcast_to(shape))

    @classmethod
    def concatenate(cls, parts, axis: int = 0) -> "GF2":
        return cls(GF.concatenate([p.a for p in parts], axis),
                   GF.concatenate([p.b for p in parts], axis))

    # -- arithmetic -------------------------------------------------------
    def _coerce(self, other) -> "GF2":
        if isinstance(other, GF2):
            return other
        if isinstance(other, GF):
            return GF2.from_base(other)
        if isinstance(other, (int, np.integer)):
            return GF2.full((), int(other), 0, self.device)
        raise TypeError(f"cannot coerce {type(other)} to GF2")

    def __add__(self, other) -> "GF2":
        o = self._coerce(other)
        return GF2(self.a + o.a, self.b + o.b)

    __radd__ = __add__

    def __sub__(self, other) -> "GF2":
        o = self._coerce(other)
        return GF2(self.a - o.a, self.b - o.b)

    def __rsub__(self, other) -> "GF2":
        return self._coerce(other).__sub__(self)

    def __mul__(self, other) -> "GF2":
        if isinstance(other, (GF, int, np.integer)):
            return GF2(self.a * other, self.b * other)
        o = self._coerce(other)
        # (a0 + b0 phi)(a1 + b1 phi) = a0a1 + W b0b1 + (a0b1 + b0a1) phi
        a0a1 = self.a * o.a
        b0b1 = self.b * o.b
        a0b1 = self.a * o.b
        b0a1 = self.b * o.a
        return GF2(a0a1 + b0b1.mul_small(W), a0b1 + b0a1)

    __rmul__ = __mul__

    def __neg__(self) -> "GF2":
        return GF2(-self.a, -self.b)

    def square(self) -> "GF2":
        a2 = self.a.square()
        b2 = self.b.square()
        ab = self.a * self.b
        return GF2(a2 + b2.mul_small(W), ab + ab)

    def pow_const(self, exp: int) -> "GF2":
        if exp < 0:
            raise ValueError("negative exponent")
        result = GF2.ones(self.shape, self.device)
        acc = self
        while exp:
            if exp & 1:
                result = result * acc
            exp >>= 1
            if exp:
                acc = acc.square()
        return result

    def sum(self, axis=None) -> "GF2":
        return GF2(self.a.sum(axis), self.b.sum(axis))
