"""Circuit configuration (twin of reference plonk/circuit_data.rs:42-110)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..fri.config import FriConfig, FriReductionStrategy, standard_fri_config


@dataclass(frozen=True)
class CircuitConfig:
    num_wires: int = 135
    num_routed_wires: int = 80
    num_constants: int = 2
    use_base_arithmetic_gate: bool = True
    security_bits: int = 100
    num_challenges: int = 2
    zero_knowledge: bool = False
    max_quotient_degree_factor: int = 8
    fri_config: FriConfig = field(default_factory=standard_fri_config)
    # transcript/commitment hasher (reference plonk/config.rs GenericConfig):
    # "poseidon" (recursable) or "keccak" (cheap non-recursive proofs,
    # KeccakGoldilocksConfig).  The inner hasher (public-input hash,
    # in-circuit) is always Poseidon, as in the reference.
    hasher: str = "poseidon"

    @staticmethod
    def standard_recursion_config() -> "CircuitConfig":
        """reference plonk/circuit_data.rs:72"""
        return CircuitConfig()

    @staticmethod
    def standard_recursion_zk_config() -> "CircuitConfig":
        return CircuitConfig(zero_knowledge=True)

    @staticmethod
    def standard_keccak_config() -> "CircuitConfig":
        """KeccakGoldilocksConfig analogue (plonk/config.rs:166): byte-digest
        commitments + keccak challenger for cheap non-recursive proofs."""
        return CircuitConfig(hasher="keccak")

    @staticmethod
    def standard_ecc_config() -> "CircuitConfig":
        """reference plonk/circuit_data.rs:92 (one extra advice wire for
        curve gadgets)."""
        return CircuitConfig(num_wires=136)

    @staticmethod
    def wide_ecc_config() -> "CircuitConfig":
        """reference plonk/circuit_data.rs:99"""
        return CircuitConfig(num_wires=234)

    def num_advice_wires(self) -> int:
        return self.num_wires - self.num_routed_wires


class PlonkOracle:
    """Commitment (oracle) indices + blinding flags (plonk_common.rs:17-39)."""

    CONSTANTS_SIGMAS = 0
    WIRES = 1
    ZS_PARTIAL_PRODUCTS = 2
    QUOTIENT = 3
    BLINDING = (False, True, True, True)  # by oracle index (zk only)
