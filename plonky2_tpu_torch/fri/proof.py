"""FRI proof containers (twin of reference fri/proof.rs:25-125).

All contents are host numpy (u64 / (..., 2) extension pairs); proofs are what
cross the host boundary anyway (serialization, verification).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..hash.merkle import MerkleCap, MerkleProof


@dataclass
class FriInitialTreeProof:
    """Openings of each oracle's Merkle leaf at one query index."""

    evals_proofs: list  # of (leaf_values (leaf_len,) u64, MerkleProof)

    def unsalted_eval(self, oracle_index: int, poly_index: int, salted: bool) -> np.uint64:
        return self.evals_proofs[oracle_index][0][poly_index]


@dataclass
class FriQueryStep:
    evals: np.ndarray  # (arity, 2) extension evals of the coset
    merkle_proof: MerkleProof


@dataclass
class FriQueryRound:
    initial_trees_proof: FriInitialTreeProof
    steps: list  # of FriQueryStep


@dataclass
class FriProof:
    commit_phase_merkle_caps: list  # of MerkleCap
    query_round_proofs: list  # of FriQueryRound
    final_poly: np.ndarray  # (final_len, 2) extension coefficients
    pow_witness: np.uint64


@dataclass
class FriChallenges:
    fri_alpha: np.ndarray  # (2,)
    fri_betas: np.ndarray  # (rounds, 2)
    fri_pow_response: np.uint64
    fri_query_indices: list  # of int
