"""PLONK proof containers (twin of reference plonk/proof.rs:28-307)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fri.proof import FriChallenges, FriProof
from ..fri.structure import FriOpeningBatch, FriOpenings
from ..hash.merkle import MerkleCap


@dataclass
class OpeningSet:
    """Claimed evaluations at zeta (and g*zeta for the Zs); all (k, 2) ext."""

    constants: np.ndarray
    plonk_sigmas: np.ndarray
    wires: np.ndarray
    plonk_zs: np.ndarray
    plonk_zs_next: np.ndarray
    partial_products: np.ndarray
    quotient_polys: np.ndarray
    lookup_zs: np.ndarray = None
    lookup_zs_next: np.ndarray = None

    def __post_init__(self):
        if self.lookup_zs is None:
            self.lookup_zs = np.zeros((0, 2), dtype=np.uint64)
        if self.lookup_zs_next is None:
            self.lookup_zs_next = np.zeros((0, 2), dtype=np.uint64)

    def to_fri_openings(self) -> FriOpenings:
        """Batch order (proof.rs:345): constants ++ sigmas ++ wires ++ zs ++
        partial_products ++ quotient ++ lookup_zs at zeta; zs ++ lookup_zs
        at g*zeta."""
        zeta_batch = FriOpeningBatch(values=np.concatenate([
            self.constants, self.plonk_sigmas, self.wires, self.plonk_zs,
            self.partial_products, self.quotient_polys, self.lookup_zs,
        ]))
        zeta_next_batch = FriOpeningBatch(values=np.concatenate(
            [self.plonk_zs_next, self.lookup_zs_next]))
        return FriOpenings(batches=[zeta_batch, zeta_next_batch])


@dataclass
class Proof:
    wires_cap: MerkleCap
    plonk_zs_partial_products_cap: MerkleCap
    quotient_polys_cap: MerkleCap
    openings: OpeningSet
    opening_proof: FriProof


@dataclass
class ProofWithPublicInputs:
    proof: Proof
    public_inputs: np.ndarray  # (num_pis,) u64


@dataclass
class ProofChallenges:
    plonk_betas: np.ndarray
    plonk_gammas: np.ndarray
    plonk_alphas: np.ndarray
    plonk_zeta: np.ndarray  # (2,)
    fri_challenges: FriChallenges
    plonk_deltas: np.ndarray = None  # (4*nc,) when lookups are present
