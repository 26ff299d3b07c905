"""Compressed PLONK proofs (twin of reference plonk/proof.rs:52-230
CompressedProofWithPublicInputs / compress / decompress)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fri.compression import (CompressedFriProof, compress_fri_proof,
                               decompress_fri_proof)
from ..hash.hashing import hash_no_pad_np
from ..field import gl64
from .proof import Proof, ProofWithPublicInputs
from .verifier import get_challenges


@dataclass
class CompressedProofWithPublicInputs:
    proof: Proof  # with opening_proof: CompressedFriProof
    public_inputs: np.ndarray


def _fri_indices(proof_with_pis: ProofWithPublicInputs, verifier_data,
                 common) -> list:
    public_inputs_hash = hash_no_pad_np(
        gl64.to_canonical(np.asarray(proof_with_pis.public_inputs,
                                     dtype=np.uint64)))
    challenges = get_challenges(proof_with_pis, public_inputs_hash,
                                verifier_data.circuit_digest, common)
    return list(challenges.fri_challenges.fri_query_indices)


def compress_proof(proof_with_pis: ProofWithPublicInputs, verifier_data,
                   common) -> CompressedProofWithPublicInputs:
    indices = _fri_indices(proof_with_pis, verifier_data, common)
    p = proof_with_pis.proof
    compressed = Proof(
        wires_cap=p.wires_cap,
        plonk_zs_partial_products_cap=p.plonk_zs_partial_products_cap,
        quotient_polys_cap=p.quotient_polys_cap,
        openings=p.openings,
        opening_proof=compress_fri_proof(p.opening_proof, indices,
                                         common.fri_params),
    )
    return CompressedProofWithPublicInputs(
        compressed, proof_with_pis.public_inputs)


def decompress_proof(compressed: CompressedProofWithPublicInputs,
                     verifier_data, common) -> ProofWithPublicInputs:
    # The transcript up to the query indices doesn't involve query rounds,
    # so challenges can be replayed from the compressed proof directly.
    p = compressed.proof
    shim = ProofWithPublicInputs(
        Proof(p.wires_cap, p.plonk_zs_partial_products_cap,
              p.quotient_polys_cap, p.openings, _FriShim(p.opening_proof)),
        compressed.public_inputs)
    indices = _fri_indices(shim, verifier_data, common)
    full = Proof(
        wires_cap=p.wires_cap,
        plonk_zs_partial_products_cap=p.plonk_zs_partial_products_cap,
        quotient_polys_cap=p.quotient_polys_cap,
        openings=p.openings,
        opening_proof=decompress_fri_proof(p.opening_proof, indices,
                                           common.fri_params),
    )
    return ProofWithPublicInputs(full, compressed.public_inputs)


class _FriShim:
    """Exposes the transcript-relevant fields of a CompressedFriProof with
    the FriProof attribute names used by get_challenges."""

    def __init__(self, compressed: CompressedFriProof):
        self.commit_phase_merkle_caps = compressed.commit_phase_merkle_caps
        self.final_poly = compressed.final_poly
        self.pow_witness = compressed.pow_witness
