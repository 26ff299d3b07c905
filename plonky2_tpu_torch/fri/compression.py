"""Compressed FRI proofs: query-round dedup + Merkle path compression.

Twin of reference fri/proof.rs:93-180 (compress/decompress).  Query indices
are Fiat-Shamir challenges, so both directions take the recomputed index
list instead of storing it.
"""

from __future__ import annotations

import numpy as np

from ..hash.path_compression import (compress_merkle_proofs,
                                     decompress_merkle_proofs)
from .config import FriParams
from .proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                    FriQueryStep)


class CompressedFriProof:
    def __init__(self, commit_phase_merkle_caps, query_rounds, final_poly,
                 pow_witness):
        self.commit_phase_merkle_caps = commit_phase_merkle_caps
        # query_rounds: (unique initial evals per oracle, compressed initial
        # merkle proofs per oracle, per reduction round (evals, compressed
        # merkle proofs))
        self.query_rounds = query_rounds
        self.final_poly = final_poly
        self.pow_witness = pow_witness


def compress_fri_proof(proof: FriProof, indices: list,
                       params: FriParams) -> CompressedFriProof:
    # deduplicate query rounds by index, keeping first occurrences in order
    unique: dict = {}
    for idx, r in zip(indices, proof.query_round_proofs):
        unique.setdefault(idx, r)
    u_indices = list(unique.keys())
    rounds = list(unique.values())

    cap_height = params.config.cap_height
    num_oracles = len(rounds[0].initial_trees_proof.evals_proofs)

    initial_evals = [[r.initial_trees_proof.evals_proofs[o][0] for r in rounds]
                     for o in range(num_oracles)]
    initial_proofs = [
        compress_merkle_proofs(
            cap_height, u_indices,
            [r.initial_trees_proof.evals_proofs[o][1] for r in rounds])
        for o in range(num_oracles)
    ]

    steps = []
    idxs = list(u_indices)
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        idxs = [x >> arity_bits for x in idxs]
        evals = [r.steps[i].evals for r in rounds]
        proofs = compress_merkle_proofs(
            cap_height, idxs, [r.steps[i].merkle_proof for r in rounds])
        steps.append((evals, proofs))

    return CompressedFriProof(
        proof.commit_phase_merkle_caps,
        (initial_evals, initial_proofs, steps),
        proof.final_poly, proof.pow_witness)


def decompress_fri_proof(compressed: CompressedFriProof, indices: list,
                         params: FriParams) -> FriProof:
    unique: dict = {}
    for pos, idx in enumerate(indices):
        unique.setdefault(idx, pos)
    u_indices = list(unique.keys())
    cap_height = params.config.cap_height
    lde_bits = params.lde_bits()

    initial_evals, initial_proofs, steps = compressed.query_rounds
    num_oracles = len(initial_evals)

    full_initial = [
        decompress_merkle_proofs(initial_evals[o], u_indices,
                                 initial_proofs[o], lde_bits, cap_height)
        for o in range(num_oracles)
    ]

    full_steps = []
    idxs = list(u_indices)
    height = lde_bits
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        idxs = [x >> arity_bits for x in idxs]
        height -= arity_bits
        evals, proofs = steps[i]
        leaves = [np.asarray(e, dtype=np.uint64).reshape(-1) for e in evals]
        full_steps.append((evals,
                           decompress_merkle_proofs(leaves, idxs, proofs,
                                                    height, cap_height)))

    unique_rounds = []
    for k in range(len(u_indices)):
        evals_proofs = [(initial_evals[o][k], full_initial[o][k])
                        for o in range(num_oracles)]
        round_steps = [FriQueryStep(full_steps[i][0][k], full_steps[i][1][k])
                       for i in range(len(params.reduction_arity_bits))]
        unique_rounds.append(FriQueryRound(
            FriInitialTreeProof(evals_proofs), round_steps))

    by_index = dict(zip(u_indices, unique_rounds))
    return FriProof(compressed.commit_phase_merkle_caps,
                    [by_index[i] for i in indices],
                    compressed.final_poly, compressed.pow_witness)
