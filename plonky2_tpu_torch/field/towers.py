"""Quartic (D=4) and quintic (D=5) Goldilocks extension towers.

Host twins of reference field/src/extension/{quartic,quintic}.rs and
goldilocks_extensions.rs:40-95: GF(p^D) = GF(p)[X]/(X^D - W) with W = 7 for
D = 4 and W = 3 for D = 5.  Elements are (..., D) uint64 arrays.  Used by
wide-extension configs and field-layer parity tests; the proving pipeline's
default D = 2 path lives in gl64ext/extension.
"""

from __future__ import annotations

import numpy as np

from . import gl64

P = gl64.ORDER_INT

# irreducibility verified in Sage (reference goldilocks_extensions.rs:18,43,72)
W4 = 7
W5 = 3
DTH_ROOT_4 = 281474976710656          # W^((p-1)/4)
DTH_ROOT_5 = 1041288259238279555      # W^((p-1)/5)


class ExtTower:
    """Generic OEF GF(p^D) with X^D = W on (..., D) u64 arrays."""

    def __init__(self, d: int, w: int, dth_root: int):
        self.D = d
        self.W = np.uint64(w)
        self.dth_root = dth_root

    # -- construction -------------------------------------------------------
    def make(self, coeffs) -> np.ndarray:
        a = np.asarray(coeffs, dtype=np.uint64)
        assert a.shape[-1] == self.D
        return a

    def from_base(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.uint64)
        out = np.zeros(x.shape + (self.D,), dtype=np.uint64)
        out[..., 0] = x
        return out

    def zero(self) -> np.ndarray:
        return np.zeros(self.D, dtype=np.uint64)

    def one(self) -> np.ndarray:
        return self.from_base(np.uint64(1))

    # -- arithmetic -----------------------------------------------------------
    def add(self, x, y):
        return gl64.add(x, y)

    def sub(self, x, y):
        return gl64.sub(x, y)

    def mul(self, x, y):
        """Schoolbook with X^D = W wraparound."""
        d = self.D
        out = np.zeros(np.broadcast_shapes(x.shape, y.shape), dtype=np.uint64)
        x = np.broadcast_to(x, out.shape)
        y = np.broadcast_to(y, out.shape)
        for i in range(d):
            for j in range(d):
                t = gl64.mul(x[..., i], y[..., j])
                k = i + j
                if k >= d:
                    k -= d
                    t = gl64.mul(t, self.W)
                out[..., k] = gl64.add(out[..., k], t)
        return out

    def scalar_mul(self, x, s):
        return gl64.mul(x, np.uint64(int(s) % P))

    def square(self, x):
        return self.mul(x, x)

    def pow_int(self, x, e: int):
        result = np.broadcast_to(self.one(), x.shape).copy()
        acc = x
        while e:
            if e & 1:
                result = self.mul(result, acc)
            e >>= 1
            if e:
                acc = self.square(acc)
        return result

    def frobenius(self, x, count: int = 1):
        """x -> x^(p^count): coefficient i scaled by DTH_ROOT^(i*count)
        (reference extension/mod.rs:29 Frobenius via OEF structure)."""
        z0 = pow(self.dth_root, count % self.D, P)
        out = x.copy()
        z = 1
        for i in range(self.D):
            out[..., i] = gl64.mul(x[..., i], np.uint64(z))
            z = (z * z0) % P
        return out

    def inv(self, x):
        """Inverse via the norm map: prod of Frobenius conjugates is in GF(p)
        (reference extension/quartic.rs try_inverse pattern)."""
        # a_pow_r_minus_1 = prod_{i=1..D-1} x^(p^i); norm = x * that in GF(p)
        acc = None
        for i in range(1, self.D):
            f = self.frobenius(x, i)
            acc = f if acc is None else self.mul(acc, f)
        norm_full = self.mul(x, acc)
        norm = norm_full[..., 0]  # the norm lands in the base field
        norm_inv = gl64.inv(norm)
        return gl64.mul(acc, norm_inv[..., None])

    def equal(self, x, y) -> bool:
        return bool(np.array_equal(gl64.to_canonical(np.asarray(x)),
                                   gl64.to_canonical(np.asarray(y))))


QUARTIC = ExtTower(4, W4, DTH_ROOT_4)
QUINTIC = ExtTower(5, W5, DTH_ROOT_5)
