"""The port's coset LDE (plonky2_tpu_torch.field.ntt.lde, plain version on the
CPU) and its commitment against the JAX package's MXU LDE twin
(mxu_lde_jnp through natural_perm_from_mem / leaf_perm_from_mem) and its
PolynomialBatch, exactly."""

import numpy as np
import pytest

from plonky2_tpu.field import gl64 as jgl64
from plonky2_tpu.field.goldilocks import GF as JGF
from plonky2_tpu.fri.oracle import PolynomialBatch as JPolynomialBatch
from plonky2_tpu.ops import mxu_lde_pallas as M
from plonky2_tpu_torch.field import ntt
from plonky2_tpu_torch.field.goldilocks import GF
from plonky2_tpu_torch.fri.oracle import COSET_SHIFT, PolynomialBatch

P = jgl64.ORDER_INT


@pytest.mark.parametrize("log_n,rate,n2,k", [
    (10, 3, 128, 3),
    (12, 2, 256, 2),
    (9, 1, 128, 1),
])
def test_lde_matches_mxu_twin(log_n, rate, n2, k):
    rng = np.random.default_rng(log_n * 100 + rate)
    n = 1 << log_n
    c = rng.integers(0, 1 << 64, size=(k, n), dtype=np.uint64)
    mem = M.mxu_lde_jnp(JGF.from_u64(c), rate, shift=7, n2=n2).to_u64().reshape(
        k, n << rate)
    nat = jgl64.to_canonical(mem[:, M.natural_perm_from_mem(log_n, rate, n2)])
    x = GF.from_u64(c, "cpu")
    assert np.array_equal(ntt.lde_torch(x, rate, 7).to_u64(), nat)
    assert np.array_equal(ntt.lde(x, rate, 7).to_u64(), nat)
    # Merkle leaf order: rows of the LDE matrix in bit-reversed order
    batch = PolynomialBatch.from_coeffs(x, rate, False, cap_height=0)
    leaves = jgl64.to_canonical(mem[:, M.leaf_perm_from_mem(log_n, rate, n2)]).T
    assert np.array_equal(batch.merkle_tree.leaves.to_u64(), leaves)
    assert np.array_equal(batch.lde_values_natural().to_u64(), nat)


def test_lde_dispatch_is_by_device(rng):
    c = GF.from_u64(rng.integers(0, P, size=(2, 16), dtype=np.uint64), "cpu")
    before = ntt.COSET_LDE.launches
    ntt.lde(c, 1, 7)
    assert ntt.COSET_LDE.launches == before            # CPU: plain version
    with pytest.raises(ValueError, match="CUDA"):
        ntt.lde_cuda(c, 1, 7)


def test_from_values_cap_matches_jax():
    rng = np.random.default_rng(12)
    n, rate, cap_height = 1 << 12, 1, 12   # one compress level
    values = rng.integers(0, P, size=(2, n), dtype=np.uint64)
    port = PolynomialBatch.from_values(GF.from_u64(values, "cpu"), rate, False,
                                       cap_height)
    ref = JPolynomialBatch.from_values(JGF.from_u64(values), rate, False,
                                       cap_height)
    assert np.array_equal(port.merkle_tree.cap.data, ref.merkle_tree.cap.data)
    assert np.array_equal(port.polynomials.to_u64(), ref.polynomials.to_u64())
    assert np.array_equal(port.lde_values_natural().to_u64(),
                          jgl64.lde_np(ref.polynomials.to_u64(), rate, COSET_SHIFT))
