"""STARK configuration (twin of reference starky/src/config.rs:4-34)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fri.config import FriConfig, FriReductionStrategy


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2
    fri_config: FriConfig = field(default_factory=lambda: FriConfig(
        rate_bits=1,
        cap_height=4,
        proof_of_work_bits=16,
        reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
        num_query_rounds=84,
    ))
    # hasher config (reference GenericConfig: PoseidonGoldilocksConfig /
    # KeccakGoldilocksConfig, plonk/config.rs:124) — selects the Merkle
    # digest and the challenger duplex for commitments and transcripts
    hasher: str = "poseidon"

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig()

    @staticmethod
    def standard_keccak_config() -> "StarkConfig":
        """Keccak commitments/transcript: cheaper to verify natively
        on-chain, not recursion-friendly (plonk/config.rs:72)."""
        return StarkConfig(hasher="keccak")

    def fri_params(self, degree_bits: int):
        return self.fri_config.fri_params(degree_bits, False)
