"""The port's coset LDE (plonky2_tpu_torch.field.ntt.lde, plain version on the
CPU; csrc/ntt.cu's lde entry on the card) and its commitment against the JAX package's MXU LDE twins
(mxu_lde_jnp through natural_perm_from_mem / leaf_perm_from_mem, and the
large-n mxu_lde3_jnp through natural_perm3_from_mem) and its
PolynomialBatch, exactly."""

import numpy as np
import pytest
import torch

from plonky2_tpu.field import gl64 as jgl64
from plonky2_tpu.field.goldilocks import GF as JGF
from plonky2_tpu.fri.oracle import PolynomialBatch as JPolynomialBatch
from plonky2_tpu.ops import mxu_lde3_pallas as M3
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


@pytest.mark.parametrize("log_n,rate,k", [(14, 1, 2), (15, 2, 1)])
def test_lde_matches_mxu_lde3_twin(log_n, rate, k):
    """The plain LDE that both LDE kernels are held to, against the
    three-step MXU twin at the shapes of tests/test_mxu_lde.py."""
    rng = np.random.default_rng(log_n * 10 + rate)
    c = rng.integers(0, P, size=(k, 1 << log_n), dtype=np.uint64)
    mem = M3.mxu_lde3_jnp(JGF.from_u64(c), rate, shift=7).to_u64().reshape(
        k, (1 << log_n) << rate)
    nat = jgl64.to_canonical(mem[:, M3.natural_perm3_from_mem(log_n, rate, 128, 128)])
    assert np.array_equal(ntt.lde_torch(GF.from_u64(c, "cpu"), rate, 7).to_u64(), nat)


def test_lde_dispatch_is_by_device(rng):
    c = GF.from_u64(rng.integers(0, P, size=(2, 1 << 11), dtype=np.uint64), "cpu")
    before = ntt.LDE.launches
    got = ntt.lde(c, 1, 7)
    # CPU: plain version
    assert ntt.LDE.launches == before
    assert np.array_equal(got.to_u64(), ntt.lde_torch(c, 1, 7).to_u64())
    with pytest.raises(ValueError, match="CUDA"):
        ntt.lde_cuda(c, 1, 7)


# (log n, rate_bits, taken): the STARK 2^5 / 2^10 / 2^20 paths call (5, 1),
# (10, 1) and (20, 1), plonk m = 2 and m = 64 call (3, 3) and (15, 3)
# (standard configs; every LDE of a prove has the same shape)
@pytest.mark.parametrize("log_n,rate_bits,ok", [
    (5, 1, True), (10, 1, True), (20, 1, True), (3, 3, True), (15, 3, True),
    (16, 3, True), (8, 3, True), (0, 0, True),
    (4, 8, True), (6, 6, True), (2, 11, True),   # one pass: any rate
    (2, 12, False), (12, 11, False),             # more than the first pass
    (30, 4, False)])                             # more than 2^33 points
def test_lde3_rate_bits_fit_the_first_pass(log_n, rate_bits, ok):
    """ntt.cu's lde entry skips the zero padding inside the first pass of
    its plan, so 2^rate_bits may not exceed that pass's length (the whole
    transform up to 2^13 points, 2^ceil(log N / 2) up to 2^18, 2^ceil(log N
    / 3) above), and the plan covers at most 2^33 points; the wrapper
    rejects other shapes before it reaches the card."""
    # the wrapper reads only the shape: a broadcast view holds no memory
    c = GF(torch.zeros(1, 1, dtype=torch.int64).expand(1, 1 << log_n))
    with pytest.raises(ValueError, match="CUDA" if ok else "exceed"):
        ntt.lde_cuda(c, rate_bits)


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


def test_from_values_column_tree_matches_jax():
    """The commitment's tree holds the LDE itself as its leaf columns (no
    (N, k) copy) and gives the JAX package's cap, opened leaves, siblings
    and get_leaf."""
    rng = np.random.default_rng(13)
    n, rate, cap_height = 16, 1, 4
    values = rng.integers(0, P, size=(9, n), dtype=np.uint64)
    port = PolynomialBatch.from_values(GF.from_u64(values, "cpu"), rate, False,
                                       cap_height)
    ref = JPolynomialBatch.from_values(JGF.from_u64(values), rate, False,
                                       cap_height)
    tree, jtree = port.merkle_tree, ref.merkle_tree
    assert tree.columns.v.data_ptr() == port.lde_values.v.data_ptr()
    assert tree._rows is None
    assert np.array_equal(tree.cap.data, jtree.cap.data)
    idx = np.array([0, 5, 31, 16, 5])
    got, want = tree.open(idx), jtree.open(idx)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    for i in (3, 30):
        assert np.array_equal(tree.get_leaf(i), jtree.get_leaf(i))


@pytest.mark.parametrize("k", [3, 9])
def test_blinded_commitment_opens_and_verifies(k):
    """Under blinding the tree's columns are the LDE plus SALT_SIZE random
    rows, the batch's LDE values a view of them; salts are random, so the
    cap is checked by shape and the openings by both packages' verifiers."""
    from plonky2_tpu.hash.merkle import MerkleProof as JMerkleProof
    from plonky2_tpu.hash.merkle import \
        verify_merkle_proof_to_cap as jverify_merkle_proof_to_cap
    from plonky2_tpu_torch.fri.oracle import SALT_SIZE
    from plonky2_tpu_torch.hash.merkle import verify_merkle_proofs_to_cap
    rng = np.random.default_rng(k)
    n, rate, cap_height = 16, 1, 4
    values = rng.integers(0, P, size=(k, n), dtype=np.uint64)
    port = PolynomialBatch.from_values(GF.from_u64(values, "cpu"), rate, True,
                                       cap_height)
    tree = port.merkle_tree
    assert tree.leaf_len == k + SALT_SIZE
    assert tree.columns.shape == (k + SALT_SIZE, n << rate)
    assert tree.columns.v.data_ptr() == port.lde_values.v.data_ptr()
    assert port.lde_values.shape == (k, n << rate)
    assert np.array_equal(port.lde_values.to_u64(),
                          jgl64.lde_np(port.polynomials.to_u64(), rate,
                                       COSET_SHIFT))
    assert tree.cap.data.shape == (1 << cap_height, 4)
    idx = np.array([0, 7, 31, 7])
    leaves, sibs = tree.open(idx)
    assert leaves.shape == (4, k + SALT_SIZE)
    assert verify_merkle_proofs_to_cap(leaves, idx, tree.cap, sibs)
    for q, i in enumerate(idx):
        assert jverify_merkle_proof_to_cap(leaves[q], int(i), tree.cap,
                                           JMerkleProof(sibs[q]))
    leaves[1, -1] ^= np.uint64(1)                      # a salt element
    assert not verify_merkle_proofs_to_cap(leaves, idx, tree.cap, sibs)
