"""The port's Merkle path compression and compressed proofs
(plonky2_tpu_torch.hash.path_compression, fri.compression,
plonk.compression) against the JAX package on tests/test_compression.py's
cases: the compressed forms equal the JAX package's field by field,
decompression restores the proof bytes, and the verifiers accept the
result."""

import numpy as np
import pytest

from plonky2_tpu.hash.path_compression import \
    compress_merkle_proofs as jcompress_paths
from plonky2_tpu.plonk.compression import compress_proof as jcompress
from plonky2_tpu.plonk.compression import decompress_proof as jdecompress
from plonky2_tpu.utils.serialization import \
    proof_with_pis_from_bytes as jfrom_bytes
from plonky2_tpu.utils.serialization import proof_with_pis_to_bytes as jto_bytes
from plonky2_tpu_torch.field.goldilocks import GF
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.hash.merkle import MerkleTree, verify_merkle_proof_to_cap
from plonky2_tpu_torch.hash.path_compression import (compress_merkle_proofs,
                                                     decompress_merkle_proofs)
from plonky2_tpu_torch.plonk.builder import CircuitBuilder
from plonky2_tpu_torch.plonk.compression import (compress_proof,
                                                 decompress_proof)
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.verifier import verify
from plonky2_tpu_torch.plonk.witness import PartialWitness
from plonky2_tpu_torch.utils.serialization import (proof_with_pis_from_bytes,
                                                   proof_with_pis_to_bytes)

INDICES = [3, 9, 10, 11, 42, 43, 60]


def test_path_compression_roundtrip():
    rng = np.random.default_rng(0)
    n, cap_height = 64, 2
    leaves = rng.integers(0, (1 << 64) - 1, size=(n, 7), dtype=np.uint64)
    tree = MerkleTree(GF.from_u64(leaves, "cpu"), cap_height)
    proofs = [tree.prove(i) for i in INDICES]

    compressed = compress_merkle_proofs(cap_height, INDICES, proofs)
    jcompressed = jcompress_paths(cap_height, INDICES, proofs)
    assert len(compressed) == len(jcompressed)
    for p, q in zip(compressed, jcompressed):
        assert np.array_equal(p.siblings, q.siblings)
    assert (sum(len(p.siblings) for p in compressed)
            < sum(len(p.siblings) for p in proofs))

    decompressed = decompress_merkle_proofs(
        [leaves[i] for i in INDICES], INDICES, compressed,
        height=6, cap_height=cap_height)
    for i, p in zip(INDICES, decompressed):
        assert verify_merkle_proof_to_cap(leaves[i], i, tree.cap, p)
        assert np.array_equal(p.siblings, tree.prove(i).siblings)


@pytest.fixture(scope="module")
def proof():
    """tests/test_compression.py's x^2 + y + 42 circuit under its fast
    config, built and proved by the port on the CPU: (data, proof)."""
    config = CircuitConfig(fri_config=FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
        num_query_rounds=4))
    b = CircuitBuilder(config)
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    out = b.add(b.mul(x, x), b.add_const(y, 42))
    b.register_public_inputs([x, y, out])
    data = b.build(device="cpu")
    pw = PartialWitness()
    pw.set_target(x, 3)
    pw.set_target(y, 5)
    return data, data.prove(pw)


def _assert_paths_equal(ps, qs):
    assert len(ps) == len(qs)
    for p, q in zip(ps, qs):
        assert np.array_equal(p.siblings, q.siblings)


def test_compressed_proof_matches_jax(proof):
    """The JAX package compresses the same proof, read from its bytes by
    the JAX package's serializer (its compression is host numpy, so the
    circuit's common data is the port's)."""
    data, proof = proof
    blob = proof_with_pis_to_bytes(proof)
    jproof = jfrom_bytes(blob, data.common)
    assert jto_bytes(jproof) == blob
    got = compress_proof(proof, data.verifier_only, data.common)
    want = jcompress(jproof, data.verifier_only, data.common)
    assert np.array_equal(got.public_inputs, want.public_inputs)
    for name in ("wires_cap", "plonk_zs_partial_products_cap",
                 "quotient_polys_cap"):
        assert np.array_equal(getattr(got.proof, name).data,
                              getattr(want.proof, name).data)
    g, w = got.proof.opening_proof, want.proof.opening_proof
    assert [c.data.tolist() for c in g.commit_phase_merkle_caps] == \
        [c.data.tolist() for c in w.commit_phase_merkle_caps]
    assert np.array_equal(g.final_poly, w.final_poly)
    assert int(g.pow_witness) == int(w.pow_witness)
    (g_evals, g_paths, g_steps), (w_evals, w_paths, w_steps) = \
        g.query_rounds, w.query_rounds
    assert len(g_evals) == len(w_evals)
    for ge, we in zip(g_evals, w_evals):
        assert len(ge) == len(we)
        assert all(np.array_equal(a, b) for a, b in zip(ge, we))
    for gp, wp in zip(g_paths, w_paths):
        _assert_paths_equal(gp, wp)
    assert len(g_steps) == len(w_steps)
    for (ge, gp), (we, wp) in zip(g_steps, w_steps):
        assert len(ge) == len(we)
        assert all(np.array_equal(a, b) for a, b in zip(ge, we))
        _assert_paths_equal(gp, wp)
    # and the JAX package's decompression of it restores the same bytes
    assert jto_bytes(jdecompress(want, data.verifier_only, data.common)) == blob


def test_compressed_proof_roundtrip(proof):
    data, proof = proof
    compressed = compress_proof(proof, data.verifier_only, data.common)
    restored = decompress_proof(compressed, data.verifier_only, data.common)
    blob = proof_with_pis_to_bytes(restored)
    assert blob == proof_with_pis_to_bytes(proof)
    verify(restored, data.verifier_only, data.common)
    verify(proof_with_pis_from_bytes(blob, data.common), data.verifier_only,
           data.common)
