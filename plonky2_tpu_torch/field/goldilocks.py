"""Goldilocks field (p = 2^64 - 2^32 + 1) on torch tensors.

A field element is its u64 bit pattern held in a ``torch.int64`` tensor, one
tensor per array (``GF.v``).  torch has no usable unsigned 64-bit arithmetic
(``torch.uint64`` lacks add, sub, shifts, compares and ``where``), so the
plain ops below run on int64 and:

  * rely on two's-complement wrap-around of int64 add, sub and mul, which is
    the u64 wrap the algorithms need (pinned by tests/test_torch_field.py);
  * compare unsigned by flipping the sign bit of both sides (``ult``);
  * shift right logically by masking after the arithmetic shift (``srl32``).

The algorithms are those of the host twin ``gl64`` (reference
field/src/goldilocks_field.rs:346-390).  Values stay noncanonical (any u64
represents its residue); ``canonical``/``to_u64`` normalise into [0, p) at
hash, transcript and proof boundaries, as the reference does.

CUDA kernels (csrc/) reinterpret the same buffers as ``uint64_t``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import gl64

ORDER = gl64.ORDER_INT
EPSILON = 0xFFFFFFFF                 # 2^64 mod p
_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)                   # int64 with only the sign bit set
_P_I64 = ORDER - (1 << 64)           # p as an int64 bit pattern


def to_i64(x: int) -> int:
    """A u64 python int as the int64 with the same bit pattern."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def srl32(x: torch.Tensor) -> torch.Tensor:
    """Logical x >> 32."""
    return (x >> 32) & _M32


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Reduce u64 residues into [0, p)."""
    return torch.where(ult(x, _P_I64), x, x - _P_I64)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p for arbitrary u64 inputs (gl64.add)."""
    s = a + b
    carry = ult(s, a)
    s2 = s + carry * EPSILON
    carry2 = carry & ult(s2, s)
    return s2 + carry2 * EPSILON


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p for arbitrary u64 inputs (gl64.sub)."""
    b = canonical(b)
    d = a - b
    borrow = ult(a, b)
    d2 = d - borrow * EPSILON
    borrow2 = borrow & ult(d, d2)
    return d2 - borrow2 * EPSILON


def neg(a: torch.Tensor) -> torch.Tensor:
    a = canonical(a)
    return torch.where(a == 0, a, _P_I64 - a)


def reduce128(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi * 2^64 + lo) mod p (gl64.reduce128)."""
    hi_hi = srl32(hi)
    hi_lo = hi & _M32
    t0 = lo - hi_hi
    t0 = t0 - ult(lo, hi_hi) * EPSILON
    t1 = hi_lo * EPSILON
    t2 = t0 + t1
    return t2 + ult(t2, t1) * EPSILON


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p: 64x64 -> 128-bit product from 32-bit halves, then
    reduce128 (gl64._mul_wide)."""
    a0, a1 = a & _M32, srl32(a)
    b0, b1 = b & _M32, srl32(b)
    lolo = a0 * b0
    lohi = a0 * b1
    hilo = a1 * b0
    hihi = a1 * b1
    mid = lohi + srl32(lolo)             # < 2^64: no wrap
    mid2 = mid + hilo                    # may wrap
    carry = ult(mid2, mid)
    lo = (mid2 << 32) | (lolo & _M32)
    hi = hihi + srl32(mid2) + (carry.long() << 32)
    return reduce128(hi, lo)


@lru_cache(maxsize=4096)
def _scalar_tensor(value: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(to_i64(value), dtype=torch.int64, device=device)


def scalar(value: int, device) -> torch.Tensor:
    """A 0-d tensor holding value mod p, shared by every caller that asks
    for the same value on the same device: constraint code multiplies by
    the same constants and challenges thousands of times, and a new CUDA
    scalar each time is a host-to-device copy.  Never written in place."""
    return _scalar_tensor(int(value) % ORDER, torch.device(device))


class GF:
    """An array of Goldilocks elements: u64 bit patterns in an int64 tensor."""

    __slots__ = ("v",)

    def __init__(self, v: torch.Tensor):
        self.v = v

    # -- construction --------------------------------------------------
    @classmethod
    def from_u64(cls, x, device) -> "GF":
        """From numpy uint64 (or python int / int list) values."""
        arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
        return cls(torch.from_numpy(arr.view(np.int64).copy()).to(device))

    @classmethod
    def zeros(cls, shape, device) -> "GF":
        return cls(torch.zeros(shape, dtype=torch.int64, device=device))

    @classmethod
    def ones(cls, shape, device) -> "GF":
        return cls(torch.ones(shape, dtype=torch.int64, device=device))

    @classmethod
    def full(cls, shape, value: int, device) -> "GF":
        return cls(torch.full(shape, to_i64(int(value) % ORDER),
                              dtype=torch.int64, device=device))

    def to_u64(self) -> np.ndarray:
        """Canonical values as a host numpy uint64 array."""
        return canonical(self.v).cpu().numpy().view(np.uint64).copy()

    # -- shape plumbing -------------------------------------------------
    @property
    def shape(self):
        return tuple(self.v.shape)

    @property
    def ndim(self) -> int:
        return self.v.ndim

    @property
    def device(self) -> torch.device:
        return self.v.device

    def reshape(self, *shape) -> "GF":
        return GF(self.v.reshape(*shape))

    def __getitem__(self, idx) -> "GF":
        return GF(self.v[idx])

    def take(self, indices, axis: int = 0) -> "GF":
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64)
                              if not isinstance(indices, torch.Tensor)
                              else indices, device=self.v.device)
        return GF(torch.index_select(self.v, axis % max(self.ndim, 1), idx))

    def broadcast_to(self, shape) -> "GF":
        return GF(self.v.expand(*shape))

    def transpose(self, *axes) -> "GF":
        axes = axes or tuple(reversed(range(self.ndim)))
        return GF(self.v.permute(*axes))

    @classmethod
    def concatenate(cls, parts, axis: int = 0) -> "GF":
        return cls(torch.cat([p.v for p in parts], dim=axis))

    @classmethod
    def stack(cls, parts, axis: int = 0) -> "GF":
        return cls(torch.stack([p.v for p in parts], dim=axis))

    # -- arithmetic ------------------------------------------------------
    def _coerce(self, other) -> torch.Tensor:
        if isinstance(other, GF):
            return other.v
        if isinstance(other, (int, np.integer)):
            return scalar(int(other), self.v.device)
        raise TypeError(f"cannot coerce {type(other)} to GF")

    def __add__(self, other) -> "GF":
        return GF(add(self.v, self._coerce(other)))

    __radd__ = __add__

    def __sub__(self, other) -> "GF":
        return GF(sub(self.v, self._coerce(other)))

    def __rsub__(self, other) -> "GF":
        return GF(sub(self._coerce(other), self.v))

    def __mul__(self, other) -> "GF":
        return GF(mul(self.v, self._coerce(other)))

    __rmul__ = __mul__

    def __neg__(self) -> "GF":
        return GF(neg(self.v))

    def square(self) -> "GF":
        return GF(mul(self.v, self.v))

    def mul_small(self, c: int) -> "GF":
        return self * int(c)

    def canonical(self) -> "GF":
        return GF(canonical(self.v))

    def pow_const(self, exp: int) -> "GF":
        """self^exp for a fixed python-int exponent (square-and-multiply)."""
        if exp < 0:
            raise ValueError("negative exponent")
        result = GF.ones(self.shape, self.device)
        acc = self
        while exp:
            if exp & 1:
                result = result * acc
            exp >>= 1
            if exp:
                acc = acc.square()
        return result

    def inv(self) -> "GF":
        """Fermat inverse a^(p-2) (0 maps to 0)."""
        return self.pow_const(ORDER - 2)

    def sum(self, axis=None) -> "GF":
        """Modular sum along an axis by pairwise halving."""
        x = self.v
        if axis is None:
            x = x.reshape(-1)
            axis = 0
        x = x.movedim(axis % max(x.ndim, 1), -1)
        rem = None
        while x.shape[-1] > 1:
            n = x.shape[-1]
            if n % 2:
                tail = x[..., n - 1]
                rem = tail if rem is None else add(rem, tail)
                x = x[..., : n - 1]
            x = add(x[..., 0::2], x[..., 1::2])
        x = x[..., 0]
        return GF(x if rem is None else add(x, rem))


def exclusive_scan(vals: torch.Tensor) -> torch.Tensor:
    """[1, v0, v0 v1, ...] along the last axis by log-depth Hillis-Steele."""
    n = vals.shape[-1]
    one = torch.ones(vals.shape[:-1] + (1,), dtype=torch.int64,
                     device=vals.device)
    x = torch.cat([one, vals[..., : n - 1]], dim=-1)
    shift = 1
    while shift < n:
        x = torch.cat([x[..., :shift], mul(x[..., shift:], x[..., : n - shift])],
                      dim=-1)
        shift *= 2
    return x


def batch_inv(x: GF) -> GF:
    """Montgomery batch inversion with log-depth prefix products and one
    Fermat inverse; zeros map to zeros (twin of gl64.batch_inv)."""
    flat = canonical(x.v.reshape(-1))
    nz = flat != 0
    vals = torch.where(nz, flat, torch.ones_like(flat))
    prefix = exclusive_scan(vals)                    # prod vals[:i]
    suffix = exclusive_scan(vals.flip(0)).flip(0)    # prod vals[i+1:]
    total = GF(mul(prefix[-1:], vals[-1:]))
    out = mul(mul(prefix, suffix), total.inv().v)
    return GF(torch.where(nz, out, torch.zeros_like(out)).reshape(x.v.shape))
