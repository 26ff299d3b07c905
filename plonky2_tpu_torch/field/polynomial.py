"""Polynomial helpers: batched evaluation, extension powers, interpolation.

Twins of reference field/src/polynomial/mod.rs (eval) and
field/src/interpolation.rs (barycentric).  Polynomials are GF/GF2 arrays with
the last axis as the coefficient index; evaluation at an extension point is a
modular reduction against a powers table built by doubling.  The ``_np``
helpers are host numpy, for the verifier.
"""

from __future__ import annotations

import numpy as np

from . import gl64, gl64ext
from .extension import GF2
from .goldilocks import GF


def powers_ext(z: GF2, n: int) -> GF2:
    """[1, z, ..., z^(n-1)] as a GF2 array of shape (n,), built by doubling:
    a table of length k extends to 2k via table * z^k."""
    out = GF2.ones((1,), z.device)
    zk = z.reshape(1)
    while out.shape[0] < n:
        out = GF2.concatenate([out, out * zk], axis=0)
        if out.shape[0] < n:
            zk = zk * zk
    return out[:n]


def eval_polys_at_ext(polys: GF, zpow: GF2) -> GF2:
    """Evaluate base-coeff polynomials (..., n) at an extension point given
    its powers table zpow (n,): sum_i c_i * z^i."""
    return GF2((polys * zpow.a).sum(axis=-1), (polys * zpow.b).sum(axis=-1))


def eval_ext_polys_at_ext(polys: GF2, zpow: GF2) -> GF2:
    """Evaluate extension-coeff polynomials (..., n) at an extension point."""
    return (polys * zpow).sum(axis=-1)


# -- host (numpy) helpers for the verifier ----------------------------------

def eval_poly_ext_np(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Host Horner eval of extension-coeff poly (n, 2) at ext point (2,)."""
    acc = gl64ext.ZERO
    for c in coeffs[::-1]:
        acc = gl64ext.add(gl64ext.mul(acc, x), c)
    return acc


def barycentric_weights_np(xs: np.ndarray) -> np.ndarray:
    """Host barycentric weights for base-field points xs (k,)
    (reference field/src/interpolation.rs:31)."""
    k = len(xs)
    diffs = gl64.sub(xs[:, None], xs[None, :])
    diffs[np.arange(k), np.arange(k)] = 1
    prods = np.ones(k, dtype=np.uint64)
    for j in range(k):
        prods = gl64.mul(prods, diffs[:, j])
    return gl64.batch_inv(prods)


def interpolate_ext_np(xs: np.ndarray, ys: np.ndarray, weights: np.ndarray,
                       x: np.ndarray) -> np.ndarray:
    """Host barycentric interpolation: points (xs (k,) base, ys (k,2) ext),
    evaluated at ext x (2,) (reference interpolation.rs:53)."""
    xs_ext = gl64ext.from_base(xs)
    diffs = gl64ext.sub(np.broadcast_to(x, xs_ext.shape), xs_ext)  # x - x_i
    if np.any(gl64ext.is_zero(diffs)):
        idx = int(np.nonzero(gl64ext.is_zero(diffs))[0][0])
        return ys[idx]
    l_x = gl64ext.ONE
    for d in diffs:
        l_x = gl64ext.mul(l_x, d)
    # sum_i w_i y_i / (x - x_i), all terms at once (one vectorised inverse)
    terms = gl64ext.mul(gl64ext.scalar_mul(gl64ext.inv(diffs), weights), ys)
    return gl64ext.mul(l_x, gl64ext.total(terms))
