"""The port's torch field (plonky2_tpu_torch.field) against the JAX package's
GF/GF2 and the host twins gl64/gl64ext, on the CPU, exactly."""

import numpy as np
import pytest
import torch

from plonky2_tpu.field import gl64 as jgl64
from plonky2_tpu.field import gl64ext as jgl64ext
from plonky2_tpu.field.extension import GF2 as JGF2
from plonky2_tpu.field.goldilocks import GF as JGF
from plonky2_tpu.field.goldilocks import batch_inv as jbatch_inv
from plonky2_tpu.field.polynomial import eval_ext_polys_at_ext as jeval_ext
from plonky2_tpu.field.polynomial import eval_polys_at_ext as jeval_base
from plonky2_tpu.field.polynomial import powers_ext as jpowers_ext
from plonky2_tpu.stark.config import StarkConfig as JStarkConfig
from plonky2_tpu_torch import convert
from plonky2_tpu_torch.field import gl64, gl64ext
from plonky2_tpu_torch.field.extension import GF2
from plonky2_tpu_torch.field.goldilocks import GF, batch_inv
from plonky2_tpu_torch.field.polynomial import (eval_ext_polys_at_ext,
                                                eval_polys_at_ext, powers_ext)
from plonky2_tpu_torch.stark.config import StarkConfig

P = gl64.ORDER_INT
EDGE = np.array([0, 1, 2, P - 1, P, P + 1, 2**64 - 1, 2**63, 2**32 - 1,
                 2**32, 0xFFFFFFFE00000003], dtype=np.uint64)


def operands(rng, n=400):
    """Random u64 values (including [p, 2^64)) plus every pair of edges."""
    ea, eb = np.meshgrid(EDGE, EDGE)
    a = np.concatenate([ea.ravel(), rng.integers(0, 1 << 64, size=n, dtype=np.uint64),
                        P + rng.integers(0, 2**32 - 1, size=n, dtype=np.uint64)])
    b = np.concatenate([eb.ravel(), rng.integers(0, 1 << 64, size=n, dtype=np.uint64),
                        rng.integers(0, 1 << 64, size=n, dtype=np.uint64)])
    return a, b


def tgf(x):
    return GF.from_u64(x, "cpu")


@pytest.mark.parametrize("size", [1, 7, 1000])
def test_int64_ops_wrap_like_u64(size):
    """The plain field code relies on torch int64 add, sub, mul and << wrapping
    mod 2^64 (two's complement), at scalar and vectorised sizes."""
    rng = np.random.default_rng(size)
    a = rng.integers(0, 1 << 64, size=size, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=size, dtype=np.uint64)
    a[0], b[0] = 2**64 - 1, 2**63 + 5
    ta = torch.from_numpy(a.view(np.int64).copy())
    tb = torch.from_numpy(b.view(np.int64).copy())
    with np.errstate(over="ignore"):
        for got, want in [(ta + tb, a + b), (ta - tb, a - b), (ta * tb, a * b),
                          (ta << 32, a << np.uint64(32))]:
            assert np.array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_gl64_and_jax(rng, op):
    a, b = operands(rng)
    port = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
            "mul": lambda x, y: x * y}[op](tgf(a), tgf(b)).to_u64()
    host = jgl64.to_canonical(getattr(jgl64, op)(a, b))
    jax_ = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
            "mul": lambda x, y: x * y}[op](JGF.from_u64(a), JGF.from_u64(b)).to_u64()
    assert np.array_equal(port, host)
    assert np.array_equal(port, jax_)
    assert np.array_equal(port, gl64.to_canonical(getattr(gl64, op)(a, b)))


def test_unary_ops_match_gl64_and_jax(rng):
    a, _ = operands(rng, 100)
    x, jx = tgf(a), JGF.from_u64(a)
    assert np.array_equal((-x).to_u64(), (-jx).to_u64())
    assert np.array_equal(x.square().to_u64(), jgl64.to_canonical(jgl64.square(a)))
    assert np.array_equal(x.mul_small(41).to_u64(), jx.mul_small(41).to_u64())
    assert np.array_equal(x.canonical().v.numpy().view(np.uint64), jgl64.to_canonical(a))
    assert np.array_equal(x.pow_const(7).to_u64(), jx.pow_const(7).to_u64())
    assert np.array_equal(x.pow_const(12345678901).to_u64(),
                          jgl64.to_canonical(jgl64.pow_vec(a, 12345678901)))
    nz = a[jgl64.to_canonical(a) != 0]
    assert np.array_equal(tgf(nz).inv().to_u64(), jgl64.to_canonical(jgl64.inv(nz)))


def test_batch_inv_and_sum_match(rng):
    a = rng.integers(0, 1 << 64, size=37, dtype=np.uint64)
    a[[3, 20]] = [0, P]                    # zeros (one noncanonical) map to zero
    assert np.array_equal(batch_inv(tgf(a)).to_u64(), jbatch_inv(JGF.from_u64(a)).to_u64())
    assert np.array_equal(batch_inv(tgf(a)).to_u64(), jgl64.batch_inv(a))
    m = rng.integers(0, 1 << 64, size=(3, 13), dtype=np.uint64)
    for axis in (None, 0, 1, -1):
        assert np.array_equal(tgf(m).sum(axis).to_u64(),
                              JGF.from_u64(m).sum(axis).to_u64())


def test_shape_ops_match_numpy(rng):
    m = rng.integers(0, P, size=(4, 6), dtype=np.uint64)
    x = tgf(m)
    assert np.array_equal(x.reshape(6, 4).to_u64(), m.reshape(6, 4))
    assert np.array_equal(x.take([5, 0, 2], axis=1).to_u64(), m[:, [5, 0, 2]])
    assert np.array_equal(x.transpose().to_u64(), m.T)
    assert np.array_equal(x.transpose(1, 0).to_u64(), m.T)
    assert np.array_equal(x[1:3, ::2].to_u64(), m[1:3, ::2])
    assert np.array_equal(GF.stack([x, x], axis=1).to_u64(), np.stack([m, m], 1))
    assert np.array_equal(GF.concatenate([x, x], axis=-1).to_u64(),
                          np.concatenate([m, m], -1))
    assert np.array_equal(x[0:1].broadcast_to((3, 6)).to_u64(),
                          np.broadcast_to(m[0:1], (3, 6)))
    assert np.array_equal(GF.full((2,), P + 5, "cpu").to_u64(), [5, 5])
    assert np.array_equal(GF.zeros((2,), "cpu").to_u64() + GF.ones((2,), "cpu").to_u64(),
                          [1, 1])


def test_gf2_ops_match_gl64ext_and_jax(rng):
    a = rng.integers(0, 1 << 64, size=(50, 2), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, size=(50, 2), dtype=np.uint64)
    x = GF2.from_u64_pair(a[:, 0], a[:, 1], "cpu")
    y = GF2.from_u64_pair(b[:, 0], b[:, 1], "cpu")
    jx = JGF2.from_u64_pair(a[:, 0], a[:, 1])
    jy = JGF2.from_u64_pair(b[:, 0], b[:, 1])
    assert np.array_equal((x * y).to_u64(), jgl64ext.to_canonical(jgl64ext.mul(a, b)))
    assert np.array_equal((x * y).to_u64(), (jx * jy).to_u64())
    assert np.array_equal((x + y).to_u64(), (jx + jy).to_u64())
    assert np.array_equal((x - y).to_u64(), (jx - jy).to_u64())
    assert np.array_equal((-x).to_u64(), (-jx).to_u64())
    assert np.array_equal(x.square().to_u64(), jx.square().to_u64())
    assert np.array_equal(x.pow_const(13).to_u64(), jx.pow_const(13).to_u64())
    assert np.array_equal(x.pow_const(13).to_u64(),
                          jgl64ext.to_canonical(jgl64ext.pow_int(a, 13)))
    assert np.array_equal((x * tgf(b[:, 0])).to_u64(), (jx * JGF.from_u64(b[:, 0])).to_u64())
    assert np.array_equal(x.sum().to_u64(), jx.sum().to_u64())
    assert np.array_equal(gl64ext.mul(a, b), jgl64ext.mul(a, b))


def test_polynomial_helpers_match_jax(rng):
    z = rng.integers(0, P, size=2, dtype=np.uint64)
    polys = rng.integers(0, P, size=(3, 16), dtype=np.uint64)
    ext = rng.integers(0, P, size=(16, 2), dtype=np.uint64)
    zt = GF2.from_u64_pair(z[0], z[1], "cpu")
    zj = JGF2.from_u64_pair(z[0], z[1])
    assert np.array_equal(powers_ext(zt, 16).to_u64(), jpowers_ext(zj, 16).to_u64())
    zp, zjp = powers_ext(zt, 16), jpowers_ext(zj, 16)
    assert np.array_equal(eval_polys_at_ext(tgf(polys), zp).to_u64(),
                          jeval_base(JGF.from_u64(polys), zjp).to_u64())
    et = GF2.from_u64_pair(ext[:, 0], ext[:, 1], "cpu")
    ej = JGF2.from_u64_pair(ext[:, 0], ext[:, 1])
    assert np.array_equal(eval_ext_polys_at_ext(et, zp).to_u64(),
                          jeval_ext(ej, zjp).to_u64())


def test_convert_carries_jax_values_and_configs(rng):
    a = rng.integers(0, 1 << 64, size=(3, 5), dtype=np.uint64)
    j = JGF.from_u64(a)
    assert np.array_equal(convert.gf_from_jax(j, "cpu").to_u64(), j.to_u64())
    assert np.array_equal(convert.gf_from_jax(a, "cpu").to_u64(), jgl64.to_canonical(a))
    cfg = convert.stark_config_from_jax(JStarkConfig.standard_fast_config())
    assert cfg == StarkConfig.standard_fast_config()
    assert cfg.fri_params(10) == StarkConfig().fri_params(10)


def _horner_ext(values, alpha):
    """sum_j alpha^j values[j], one element at a time (the reference's
    ReducingFactor loop), as the loop reference for the vectorised form."""
    acc = gl64ext.ZERO
    for v in values[::-1]:
        acc = gl64ext.add(gl64ext.mul(acc, alpha), v)
    return acc


@pytest.mark.parametrize("k", [0, 1, 2, 7, 64, 139])
def test_verifier_reductions_match_their_loops(rng, k):
    """fri/verifier.py reduces opened values with vectorised alpha powers
    and sums; the results equal the element-by-element loops, for base and
    extension values, exactly."""
    from plonky2_tpu_torch.fri.verifier import _reduce_with_alpha
    alpha = rng.integers(0, P, size=2, dtype=np.uint64)
    ext = rng.integers(0, P, size=(k, 2), dtype=np.uint64)
    base = rng.integers(0, P, size=k, dtype=np.uint64)
    np.testing.assert_array_equal(
        gl64ext.to_canonical(_reduce_with_alpha(ext, alpha)),
        gl64ext.to_canonical(_horner_ext(ext, alpha)))
    np.testing.assert_array_equal(
        gl64ext.to_canonical(_reduce_with_alpha(base, alpha)),
        gl64ext.to_canonical(_horner_ext(gl64ext.from_base(base), alpha)))
    loop = [gl64ext.ONE]
    for _ in range(k - 1):
        loop.append(gl64ext.mul(loop[-1], alpha))
    np.testing.assert_array_equal(
        gl64ext.to_canonical(gl64ext.powers(alpha, k)),
        gl64ext.to_canonical(np.stack(loop)[:k].reshape(k, 2)))


def test_interpolation_matches_the_jax_loop(rng):
    """The vectorised barycentric interpolation equals the JAX package's
    per-point loop (an arity-16 coset, as the FRI verifier's folds use)."""
    from plonky2_tpu.field.polynomial import interpolate_ext_np as jinterp
    from plonky2_tpu_torch.field.polynomial import (barycentric_weights_np,
                                                    interpolate_ext_np)
    xs = gl64.to_canonical(gl64.mul(
        np.uint64(7), gl64.powers(gl64.primitive_root_of_unity(4), 16)))
    ys = rng.integers(0, P, size=(16, 2), dtype=np.uint64)
    w = barycentric_weights_np(xs)
    for x in (rng.integers(0, P, size=2, dtype=np.uint64),
              gl64ext.from_base(xs[5])):   # a node: returns ys[5]
        np.testing.assert_array_equal(
            gl64ext.to_canonical(interpolate_ext_np(xs, ys, w, x)),
            gl64ext.to_canonical(jinterp(xs, ys, w, x)))
