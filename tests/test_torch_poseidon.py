"""The port's Poseidon, hashing and Merkle tree against the JAX package's
permute, hashing and Merkle modules and its host twin permute_np, on the CPU,
exactly.

The JAX package's Pallas round-pipeline twin (ops/poseidon_pallas.py
permute_cols_jnp) is not called here: its fully unrolled graph takes XLA:CPU
many minutes to compile.  tests/test_poseidon_pallas.py holds it against
permute_np, which these tests hold the port against.
"""

import numpy as np
import pytest

from plonky2_tpu.field import gl64 as jgl64
from plonky2_tpu.field.goldilocks import GF as JGF
from plonky2_tpu.hash import hashing as jhashing
from plonky2_tpu.hash.merkle import MerkleCap as JMerkleCap
from plonky2_tpu.hash.merkle import MerkleProof as JMerkleProof
from plonky2_tpu.hash.merkle import MerkleTree as JMerkleTree
from plonky2_tpu.hash.merkle import \
    verify_merkle_proof_to_cap as jverify_merkle_proof_to_cap
from plonky2_tpu.hash.poseidon import permute as jpermute
from plonky2_tpu.hash.poseidon import permute_np as jpermute_np
from plonky2_tpu_torch.field import gl64
from plonky2_tpu_torch.field.goldilocks import GF
from plonky2_tpu_torch.hash import hashing
from plonky2_tpu_torch.hash import poseidon
from plonky2_tpu_torch.hash import poseidon_constants as C
from plonky2_tpu_torch.hash.merkle import (MerkleTree, verify_merkle_proof_to_cap,
                                          verify_merkle_proofs_to_cap)
from plonky2_tpu_torch.utils.bits import reverse_index_bits_perm

P = jgl64.ORDER_INT


@pytest.mark.parametrize("twin", ["jax", "host"])
def test_permute_matches_jax_and_host(rng, twin):
    states = rng.integers(0, 1 << 64, size=(256, 12), dtype=np.uint64)
    states[0] = 0
    states[1] = P + np.arange(12, dtype=np.uint64)      # noncanonical lanes
    got = poseidon.permute(GF.from_u64(states, "cpu")).to_u64()
    if twin == "jax":
        # 8 states (the Merkle tests' batch): each new batch shape costs the
        # JAX side a compile; the host twin below covers all 256
        got = got[:8]
        want = jpermute(JGF.from_u64(states[:8])).to_u64()
    else:
        want = jgl64.to_canonical(jpermute_np(states))
        assert np.array_equal(jgl64.to_canonical(poseidon.permute_np(states)), got)
    assert np.array_equal(got, want)


def test_permute_dispatch_is_by_device(rng):
    states = rng.integers(0, P, size=(3, 2, 12), dtype=np.uint64)
    before = poseidon.POSEIDON.launches
    got = poseidon.permute(GF.from_u64(states, "cpu"))
    assert got.shape == (3, 2, 12)
    assert poseidon.POSEIDON.launches == before        # CPU: plain version
    with pytest.raises(ValueError, match="CUDA"):
        poseidon.permute_cuda(GF.from_u64(states.reshape(6, 12), "cpu").v)


def _permute_fast_schedule_np(state):
    """A numpy mirror of csrc/poseidon.cu's round schedule: the canonical
    full rounds around the reference's fast partial rounds (poseidon.rs:584),
    in the kernel's constant order."""
    s = [state[:, i].copy() for i in range(12)]
    rc = np.array(C.ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(30, 12)

    def full(s, r):
        s = np.stack(s, axis=1)
        s = poseidon._sbox_np(gl64.add(s, rc[r]))
        s = poseidon._mds_np(s)
        return [s[:, i] for i in range(12)]

    def dot(terms):
        acc = np.zeros_like(s[0])
        for a, b in terms:
            acc = gl64.add(acc, gl64.mul(a, np.uint64(b)))
        return acc

    for r in range(4):
        s = full(s, r)
    s = [gl64.add(s[i], np.uint64(C.FAST_PARTIAL_FIRST_ROUND_CONSTANT[i]))
         for i in range(12)]
    init = C.FAST_PARTIAL_ROUND_INITIAL_MATRIX
    s = [s[0]] + [dot([(s[r], init[r - 1][c - 1]) for r in range(1, 12)])
                  for c in range(1, 12)]
    for r in range(22):
        s0 = gl64.add(poseidon._sbox_np(s[0]),
                      np.uint64(C.FAST_PARTIAL_ROUND_CONSTANTS[r]))
        w, v = C.FAST_PARTIAL_ROUND_W_HATS[r], C.FAST_PARTIAL_ROUND_VS[r]
        d = dot([(s0, C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0])]
                + [(s[i], w[i - 1]) for i in range(1, 12)])
        s = [d] + [gl64.add(gl64.mul(s0, np.uint64(v[i - 1])), s[i])
                   for i in range(1, 12)]
    for r in range(26, 30):
        s = full(s, r)
    return np.stack(s, axis=1)


def test_kernel_round_schedule_matches_permute_np(rng):
    """The fast partial-round schedule that csrc/poseidon.cu runs gives the
    canonical permutation on random, noncanonical ([p, 2^64)) and zero
    states."""
    states = rng.integers(0, 1 << 64, size=(64, 12), dtype=np.uint64)
    states[0] = 0
    states[1:17] = np.uint64(P) + rng.integers(0, (1 << 32) - 1, size=(16, 12),
                                               dtype=np.uint64)
    states[17] = np.uint64((1 << 64) - 1)
    assert np.array_equal(gl64.to_canonical(_permute_fast_schedule_np(states)),
                          gl64.to_canonical(poseidon.permute_np(states)))


def _permute_lane_schedule_np(state):
    """A numpy mirror of csrc/poseidon.cu's lane-group permutation
    (permute_lanes): 16 lanes a state, lane l < 12 holding element l, a
    shuffle being a gather over the lane axis; in the partial rounds lane
    0's S-box output broadcast to the group and the W_HATS products summed
    by an xor butterfly."""
    g, w = 16, 12
    lanes = np.arange(g)
    lc = np.minimum(lanes, w - 1)
    lm = np.where((lanes >= 1) & (lanes < w), lanes - 1, 0)
    dot_lane = (lanes >= 1) & (lanes < w)
    u64 = np.uint64
    rc = np.array(C.ALL_ROUND_CONSTANTS, dtype=u64).reshape(30, 12)
    init = np.array(C.FAST_PARTIAL_ROUND_INITIAL_MATRIX, dtype=u64).reshape(-1)
    vs = np.array(C.FAST_PARTIAL_ROUND_VS, dtype=u64).reshape(-1)
    wh = np.array(C.FAST_PARTIAL_ROUND_W_HATS, dtype=u64).reshape(-1)
    prc = list(C.FAST_PARTIAL_ROUND_CONSTANTS) + [0] * 22

    def full_round(x, r):
        x = poseidon._sbox_np(gl64.add(x, rc[r][lc]))
        acc = [0] * x.size
        for i in range(w):
            src = np.where(lanes + i >= w, lanes + i - w, lanes + i)
            acc = [a + C.MDS_MATRIX_CIRC[i] * int(v)
                   for a, v in zip(acc, x[:, src].reshape(-1))]
        acc = [a + (8 * int(v) if k % g == 0 else 0)
               for k, (a, v) in enumerate(zip(acc, x.reshape(-1)))]
        return np.array([a % P for a in acc], dtype=u64).reshape(x.shape)

    def group_sum(v):
        for m in (1, 2, 4, 8):
            v = gl64.add(v, v[:, lanes ^ m])
        return v

    x = np.zeros((state.shape[0], g), dtype=u64)
    x[:, :w] = state
    for r in range(4):
        x = full_round(x, r)
    x = gl64.add(x, np.array(C.FAST_PARTIAL_FIRST_ROUND_CONSTANT, dtype=u64)[
        np.where(lanes < w, lanes, 0)])
    acc = np.zeros_like(x)
    for r in range(1, w):
        acc = gl64.add(acc, gl64.mul(x[:, [r] * g], init[(r - 1) * (w - 1) + lm]))
    x = np.where(lanes == 0, x, acc)
    for r in range(22):
        s0 = gl64.add(poseidon._sbox_np(x), u64(prc[r]))
        dot = group_sum(np.where(dot_lane, gl64.mul(x, wh[r * 11 + lm]), u64(0)))
        b = s0[:, [0] * g]
        x = gl64.add(gl64.mul(b, np.where(lanes == 0, u64(25), vs[r * 11 + lm])),
                     np.where(lanes == 0, dot, x))
    for r in range(26, 30):
        x = full_round(x, r)
    return x[:, :w]


def test_lane_group_schedule_matches_permute_np(rng):
    """csrc/poseidon.cu's lane-group round schedule gives the canonical
    permutation on random, zero and all-ones states."""
    states = rng.integers(0, 1 << 64, size=(16, 12), dtype=np.uint64)
    states[0] = 0
    states[1] = np.uint64((1 << 64) - 1)
    assert np.array_equal(gl64.to_canonical(_permute_lane_schedule_np(states)),
                          gl64.to_canonical(poseidon.permute_np(states)))


@pytest.mark.parametrize("length", [5, 8, 9, 135])
def test_sponge_plain_matches_jax(rng, length):
    """The plain version of the fused sponge kernel (hash_no_pad_torch)
    against the JAX package's host sponges, and at length 9 its jitted
    device sponge too (the shape test_hashing_matches_jax_and_host compiles:
    each new length costs the JAX side a compile of the whole unrolled
    sponge, 10 s at length 8 and 2 min at 135 on a CPU)."""
    x = rng.integers(0, 1 << 64, size=(2, length), dtype=np.uint64)
    got = GF(hashing.hash_no_pad_torch(GF.from_u64(x, "cpu").v)).to_u64()
    assert np.array_equal(got, jhashing.hash_no_pad_np(x))
    assert np.array_equal(hashing.hash_or_noop(GF.from_u64(x, "cpu")).to_u64(),
                          jhashing.hash_or_noop_np(x))
    if length == 9:
        assert np.array_equal(got, jhashing.hash_no_pad(JGF.from_u64(x)).to_u64())


def test_hash_rows_dispatch_is_by_device(rng):
    x = rng.integers(0, P, size=(3, 2, 9), dtype=np.uint64)
    before = hashing.HASH_ROWS.launches
    got = hashing.hash_no_pad(GF.from_u64(x, "cpu"))
    assert got.shape == (3, 2, 4)
    assert hashing.HASH_ROWS.launches == before       # CPU: plain version
    assert np.array_equal(got.to_u64(), hashing.hash_no_pad_np(x))
    with pytest.raises(ValueError, match="CUDA"):
        hashing.hash_rows_cuda(GF.from_u64(x.reshape(6, 9), "cpu").v)


@pytest.mark.parametrize("leaf_order", [True, False])
@pytest.mark.parametrize("length", [3, 9, 135])
def test_hash_cols_matches_jax(length, leaf_order):
    """The column sponge (plain version here) against the JAX package's
    hash_or_noop of the transposed columns, in leaf and in column order;
    rows of a wider array (a row stride above n) read the same."""
    rng = np.random.default_rng(length)
    n = 16
    wide = rng.integers(0, P, size=(length, n + 5), dtype=np.uint64)
    cols = GF.from_u64(wide, "cpu")[:, :n]
    rows = wide[:, :n].T
    if leaf_order:
        rows = rows[reverse_index_bits_perm(n)]
    want = jhashing.hash_or_noop_np(rows)
    assert np.array_equal(hashing.hash_or_noop_cols(cols, leaf_order).to_u64(),
                          want)
    if length > 4:
        assert np.array_equal(
            hashing.hash_no_pad_cols(cols, 4, leaf_order).to_u64(), want)


def test_hash_cols_dispatch_is_by_device():
    cols = GF.from_u64(np.arange(9 * 8, dtype=np.uint64).reshape(9, 8), "cpu")
    before = hashing.HASH_COLS.launches
    hashing.hash_no_pad_cols(cols)
    assert hashing.HASH_COLS.launches == before       # CPU: plain version
    with pytest.raises(ValueError, match="CUDA"):
        hashing.hash_cols_cuda(cols.v)
    assert hashing.sponge_group(1 << 10) == hashing.SPONGE_GROUP
    assert hashing.sponge_group(1 << 20) == 1


@pytest.mark.parametrize("cap_height", [0, 4])
@pytest.mark.parametrize("leaf_len", [3, 9, 135])
def test_merkle_tree_from_columns_matches_jax(leaf_len, cap_height):
    """A tree built from (leaf_len, n) columns (leaf i: column
    reverse_bits(i)) against the JAX package's tree of the leaf rows: the
    same cap, opened leaves, siblings and get_leaf, and the rows on demand.
    For 135-element leaves the JAX package's jitted sponge takes XLA:CPU
    about a minute to compile, so there its host twins stand in: the cap
    from hash_or_noop_np and compress_np, and its host verifier."""
    rng = np.random.default_rng(leaf_len * 10 + cap_height)
    n = 32     # the JAX tree opens nothing below a cap of 2^4 roots at 16
    cols = rng.integers(0, P, size=(leaf_len, n), dtype=np.uint64)
    rows = cols.T[reverse_index_bits_perm(n)]
    tree = MerkleTree.from_columns(GF.from_u64(cols, "cpu"), cap_height)
    assert tree.leaf_len == leaf_len
    assert np.array_equal(tree.leaves.to_u64(), rows)
    idx = np.array([0, 1, 6, 31, 6])
    got_leaves, got_sibs = tree.open(idx)
    assert np.array_equal(got_leaves, rows[idx])
    if leaf_len == 135:
        level = jhashing.hash_or_noop_np(rows)
        while level.shape[0] > 1 << cap_height:
            level = jhashing.compress_np(level[0::2], level[1::2])
        assert np.array_equal(tree.cap.data, level)
        for q, i in enumerate(idx):
            assert jverify_merkle_proof_to_cap(
                got_leaves[q], int(i), JMerkleCap(level),
                JMerkleProof(got_sibs[q]))
        return
    jtree = JMerkleTree(JGF.from_u64(rows), cap_height)
    assert np.array_equal(tree.cap.data, jtree.cap.data)
    want_leaves, want_sibs = jtree.open(idx)
    assert np.array_equal(got_leaves, want_leaves)
    assert np.array_equal(got_sibs, want_sibs)
    for i in (0, 9, 31):
        assert np.array_equal(tree.get_leaf(i), jtree.get_leaf(i))


def test_hashing_matches_jax_and_host(rng):
    for length in [1, 4, 7, 8, 9, 16, 135]:
        x = rng.integers(0, P, size=(2, length), dtype=np.uint64)
        got = hashing.hash_no_pad(GF.from_u64(x, "cpu")).to_u64()
        assert np.array_equal(got, jhashing.hash_no_pad_np(x))
        assert np.array_equal(got, hashing.hash_no_pad_np(x))
        assert np.array_equal(hashing.hash_or_noop(GF.from_u64(x, "cpu")).to_u64(),
                              jhashing.hash_or_noop_np(x))
    # batch 2 throughout: the JAX side compiles one permutation shape
    x = rng.integers(0, P, size=(2, 9), dtype=np.uint64)
    assert np.array_equal(hashing.hash_no_pad(GF.from_u64(x, "cpu")).to_u64(),
                          jhashing.hash_no_pad(JGF.from_u64(x)).to_u64())
    a = rng.integers(0, P, size=(2, 4), dtype=np.uint64)
    b = rng.integers(0, P, size=(2, 4), dtype=np.uint64)
    got = hashing.compress(GF.from_u64(a, "cpu"), GF.from_u64(b, "cpu")).to_u64()
    assert np.array_equal(got, jhashing.compress(JGF.from_u64(a), JGF.from_u64(b)).to_u64())
    assert np.array_equal(got, hashing.compress_np(a, b))


@pytest.mark.parametrize("leaf_len,cap_height", [(7, 2), (4, 0)])
def test_merkle_tree_matches_jax(rng, leaf_len, cap_height):
    n = 8
    leaves = rng.integers(0, P, size=(n, leaf_len), dtype=np.uint64)
    tree = MerkleTree(GF.from_u64(leaves, "cpu"), cap_height)
    jtree = JMerkleTree(JGF.from_u64(leaves), cap_height)
    assert np.array_equal(tree.cap.data, jtree.cap.data)
    idx = np.array([0, 1, 5, 7, 5])
    got_leaves, got_sibs = tree.open(idx)
    want_leaves, want_sibs = jtree.open(idx)
    assert np.array_equal(got_leaves, want_leaves)
    assert np.array_equal(got_sibs, want_sibs)
    for i in idx:
        assert verify_merkle_proof_to_cap(leaves[i], int(i), tree.cap, tree.prove(int(i)))
        assert np.array_equal(tree.get_leaf(int(i)), leaves[i])
    assert not verify_merkle_proof_to_cap(leaves[6], 5, tree.cap, tree.prove(5))
    assert verify_merkle_proofs_to_cap(got_leaves, idx, tree.cap, got_sibs)
    if got_sibs.size:
        got_sibs[2, -1, 0] ^= np.uint64(1)
        assert not verify_merkle_proofs_to_cap(got_leaves, idx, tree.cap, got_sibs)
