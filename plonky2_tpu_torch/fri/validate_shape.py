"""Structural validation of FRI proofs before any field/hash work
(twin of reference fri/validate_shape.rs:11-69).

A malformed proof — truncated final polynomial, missing query round,
wrong-arity step evals, short Merkle path — must be a clean
``ShapeError`` (a ``ValueError``), never a numpy broadcasting error or,
worse, a zip() that silently under-iterates in the query loop.
"""

from __future__ import annotations

import numpy as np

from .oracle import SALT_SIZE


class ShapeError(ValueError):
    """A proof whose structure does not match the verification key."""


def _ensure(cond: bool, msg: str) -> None:
    if not cond:
        raise ShapeError(msg)


def _cap_height(cap) -> int:
    n = len(cap.data)
    _ensure(n > 0 and (n & (n - 1)) == 0, "cap size must be a power of two")
    return n.bit_length() - 1


def validate_fri_proof_shape(proof, instance, params,
                             digest_width: int = 4) -> None:
    """proof: FriProof; instance: FriInstanceInfo; params: FriParams
    (reference fri/validate_shape.rs:11).  ``digest_width`` is the digest
    shape in array elements: 4 u64 felts for Poseidon caps, 25 bytes for
    keccak byte-digest trees (hash/keccak_tree.py)."""
    cap_height = params.config.cap_height
    for cap in proof.commit_phase_merkle_caps:
        _ensure(_cap_height(cap) == cap_height,
                "commit-phase cap has the wrong height")
    _ensure(len(proof.commit_phase_merkle_caps)
            == len(params.reduction_arity_bits),
            "wrong number of commit-phase caps")

    _ensure(len(proof.query_round_proofs) == params.config.num_query_rounds,
            "wrong number of query rounds")
    for query_round in proof.query_round_proofs:
        itp = query_round.initial_trees_proof
        _ensure(len(itp.evals_proofs) == len(instance.oracles),
                "initial tree openings do not match the oracle count")
        for (leaf, merkle_proof), oracle in zip(itp.evals_proofs,
                                                instance.oracles):
            salt = SALT_SIZE if (oracle.blinding and params.hiding) else 0
            _ensure(len(leaf) == oracle.num_polys + salt,
                    "initial leaf length does not match the oracle")
            _ensure(merkle_proof.siblings.shape
                    == (params.lde_bits() - cap_height, digest_width),
                    "initial Merkle path has the wrong depth")

        _ensure(len(query_round.steps) == len(params.reduction_arity_bits),
                "wrong number of FRI query steps")
        codeword_len_bits = params.lde_bits()
        for step, arity_bits in zip(query_round.steps,
                                    params.reduction_arity_bits):
            codeword_len_bits -= arity_bits
            _ensure(np.shape(step.evals) == (1 << arity_bits, 2),
                    "query step evals do not match the arity")
            _ensure(step.merkle_proof.siblings.shape
                    == (codeword_len_bits - cap_height, digest_width),
                    "query step Merkle path has the wrong depth")

    _ensure(len(proof.final_poly) == params.final_poly_len(),
            "final polynomial has the wrong length")
