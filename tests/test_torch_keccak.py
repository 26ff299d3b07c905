"""The port's keccak hasher (plonky2_tpu_torch.hash.keccak_tree, native/,
the keccak challenger and PoW grind) against the JAX package on the CPU:
leaf hashes, 2-to-1 hashes, byte-digest Merkle trees and their proofs, the
hash-onion challenger permutation and the grind's witness, all exact.
These are host numpy in both packages; the native (keccak.cpp) and numpy
paths must give the same bytes."""

import numpy as np
import pytest

from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JStrategy
from plonky2_tpu.fri.prover import fri_proof_of_work as jfri_proof_of_work
from plonky2_tpu.hash import keccak_tree as jkt
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.iop.challenger import permutation_for as jpermutation_for
from plonky2_tpu_torch import native
from plonky2_tpu_torch.field import gl64
from plonky2_tpu_torch.field.goldilocks import GF
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.fri.prover import fri_proof_of_work
from plonky2_tpu_torch.hash import keccak_tree as kt
from plonky2_tpu_torch.iop.challenger import Challenger, permutation_for

P = gl64.ORDER_INT


def random_felts(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


@pytest.mark.parametrize("width", [1, 3, 4, 5, 17, 135])
def test_leaf_hash_matches_jax(width):
    """Rows of <= 3 felts are stored raw (hash_or_noop); longer rows span
    one or more 136-byte keccak blocks."""
    rows = random_felts((32, width), width)
    got = kt.keccak_hash_or_noop(rows)
    assert got.dtype == np.uint8 and got.shape == (32, 25)
    np.testing.assert_array_equal(got, jkt.keccak_hash_or_noop(rows))


def test_two_to_one_and_bytes_to_felts_match_jax():
    rng = np.random.default_rng(3)
    left = rng.integers(0, 256, size=(16, 25), dtype=np.uint8)
    right = rng.integers(0, 256, size=(16, 25), dtype=np.uint8)
    np.testing.assert_array_equal(kt.keccak_two_to_one(left, right),
                                  jkt.keccak_two_to_one(left, right))
    np.testing.assert_array_equal(kt.bytes_hash_to_felts(left),
                                  jkt.bytes_hash_to_felts(left))


@pytest.mark.parametrize("cap_height", [0, 2, 4])
def test_bytes_merkle_tree_matches_jax(cap_height):
    """Cap and every opened path equal the JAX tree's; the port's tree takes
    its leaves from a torch tensor, as the PCS gives them."""
    leaves = random_felts((64, 7), cap_height)
    tree = kt.BytesMerkleTree(GF.from_u64(leaves, "cpu"), cap_height)
    jtree = jkt.BytesMerkleTree(leaves, cap_height)
    np.testing.assert_array_equal(tree.cap.data, jtree.cap.data)
    idx = np.array([0, 5, 33, 63])
    got_leaves, got_sibs = tree.open(idx)
    np.testing.assert_array_equal(got_leaves, leaves[idx])
    for q, i in enumerate(idx):
        np.testing.assert_array_equal(got_sibs[q], jtree.prove(int(i)).siblings)
    assert kt.verify_bytes_merkle_proofs_to_cap(got_leaves, idx, tree.cap,
                                                got_sibs)
    assert jkt.verify_bytes_merkle_proof_to_cap(leaves[5], 5, jtree.cap,
                                                tree.prove(5))
    bad = got_leaves.copy()
    bad[1, 0] ^= np.uint64(1)
    assert not kt.verify_bytes_merkle_proofs_to_cap(bad, idx, tree.cap,
                                                    got_sibs)


def test_keccak_permutation_and_challenger_match_jax():
    state = random_felts((12,), 9)
    np.testing.assert_array_equal(kt.keccak_permutation_np(state),
                                  jkt.keccak_permutation_np(state))
    ch = Challenger(permutation_for("keccak"))
    jch = JChallenger(jpermutation_for("keccak"))
    digests = np.random.default_rng(4).integers(0, 256, size=(4, 25),
                                                dtype=np.uint8)
    for c in (ch, jch):
        c.observe_elements(state[:5])
        c.observe_cap(kt.BytesMerkleCap(digests))
    np.testing.assert_array_equal(ch.get_n_challenges(11),
                                  jch.get_n_challenges(11))


@pytest.mark.parametrize("pow_bits", [0, 6])
def test_keccak_pow_grind_matches_jax(pow_bits):
    """The host grind under the keccak duplex finds the JAX package's
    witness and leaves the transcript where the JAX grind leaves it."""
    def config(fc, strategy):
        return fc(rate_bits=1, cap_height=0, proof_of_work_bits=pow_bits,
                  reduction_strategy=strategy.constant_arity(4, 5),
                  num_query_rounds=2)
    ch = Challenger(permutation_for("keccak"))
    jch = JChallenger(jpermutation_for("keccak"))
    for c in (ch, jch):
        c.observe_elements(np.arange(3, dtype=np.uint64))
    w = fri_proof_of_work(ch, config(FriConfig, FriReductionStrategy), "cpu",
                          "keccak")
    assert w == jfri_proof_of_work(jch, config(JFriConfig, JStrategy))
    assert ch.get_challenge() == jch.get_challenge()


@pytest.mark.parametrize("length", [0, 50, 136, 300])
def test_native_matches_numpy(monkeypatch, length):
    """keccak.cpp (built into the package's _build/) hashes rows to the
    same bytes as the numpy keccak-f, across block boundaries."""
    if not native.available():
        pytest.fail("the native keccak library did not build (g++ missing?)")
    assert native.backend() == "native"
    rows = np.random.default_rng(length).integers(0, 256, size=(9, length),
                                                  dtype=np.uint8)
    with_native = kt._absorb_blocks(rows)
    monkeypatch.setattr(native, "available", lambda: False)
    assert native.backend() == "numpy"
    np.testing.assert_array_equal(with_native, kt._absorb_blocks(rows))


def test_native_builds_outside_the_source_tree():
    lib = native._lib_path()
    assert lib.parent.name == "native" and lib.parent.parent.name == "_build"
    assert native.available() and lib.exists()
