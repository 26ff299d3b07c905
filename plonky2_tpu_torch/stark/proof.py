"""STARK proof containers (twin of reference starky/src/proof.rs:24-183)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fri.proof import FriChallenges, FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings
from ..hash.merkle import MerkleCap


_EMPTY = None


def _empty_ext():
    return np.zeros((0, 2), dtype=np.uint64)


@dataclass
class StarkOpeningSet:
    local_values: np.ndarray   # (COLUMNS, 2)
    next_values: np.ndarray    # (COLUMNS, 2)
    quotient_polys: np.ndarray
    permutation_zs: np.ndarray = None
    permutation_zs_next: np.ndarray = None

    def __post_init__(self):
        if self.permutation_zs is None:
            self.permutation_zs = _empty_ext()
        if self.permutation_zs_next is None:
            self.permutation_zs_next = _empty_ext()

    def to_fri_openings(self) -> FriOpenings:
        """(proof.rs:161): zeta batch = local ++ perm ++ quotient;
        g*zeta batch = next ++ perm_next."""
        return FriOpenings(batches=[
            FriOpeningBatch(values=np.concatenate(
                [self.local_values, self.permutation_zs, self.quotient_polys])),
            FriOpeningBatch(values=np.concatenate(
                [self.next_values, self.permutation_zs_next])),
        ])


@dataclass
class StarkProof:
    trace_cap: MerkleCap
    quotient_polys_cap: MerkleCap
    openings: StarkOpeningSet
    opening_proof: FriProof
    permutation_zs_cap: MerkleCap = None


@dataclass
class StarkProofWithPublicInputs:
    proof: StarkProof
    public_inputs: np.ndarray


@dataclass
class StarkProofChallenges:
    stark_alphas: np.ndarray
    stark_zeta: np.ndarray
    fri_challenges: FriChallenges
    permutation_challenge_sets: list = None
