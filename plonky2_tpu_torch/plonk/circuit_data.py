"""Circuit data: common/prover/verifier artifacts of `build()`.

Twin of reference plonk/circuit_data.rs:116-609.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fri.config import FriParams
from ..fri.structure import (FriBatchInfo, FriInstanceInfo, FriOracleInfo,
                             FriPolynomialInfo)
from ..field import gl64, gl64ext
from .config import CircuitConfig, PlonkOracle


@dataclass
class SelectorsInfo:
    selector_indices: list
    groups: list  # of range

    def num_selectors(self) -> int:
        return len(self.groups)


class CommonCircuitData:
    def __init__(self, config: CircuitConfig, fri_params: FriParams, gates: list,
                 selectors_info: SelectorsInfo, quotient_degree_factor: int,
                 num_gate_constraints: int, num_constants: int,
                 num_public_inputs: int, k_is: np.ndarray,
                 num_partial_products: int, num_lookup_polys: int = 0,
                 num_lookup_selectors: int = 0, luts: list | None = None):
        self.config = config
        self.fri_params = fri_params
        self.gates = gates
        self.selectors_info = selectors_info
        self.quotient_degree_factor = quotient_degree_factor
        self.num_gate_constraints = num_gate_constraints
        self.num_constants = num_constants
        self.num_public_inputs = num_public_inputs
        self.k_is = k_is
        self.num_partial_products = num_partial_products
        self.num_lookup_polys = num_lookup_polys
        self.num_lookup_selectors = num_lookup_selectors
        self.luts = luts or []

    def has_lookup(self) -> bool:
        return self.num_lookup_polys != 0

    def num_all_lookup_polys(self) -> int:
        return self.config.num_challenges * self.num_lookup_polys

    def degree_bits(self) -> int:
        return self.fri_params.degree_bits

    def degree(self) -> int:
        return 1 << self.degree_bits()

    def lde_size(self) -> int:
        return self.fri_params.lde_size()

    def quotient_degree(self) -> int:
        return self.quotient_degree_factor * self.degree()

    def constants_range(self):
        return range(0, self.num_constants)

    def sigmas_range(self):
        return range(self.num_constants,
                     self.num_constants + self.config.num_routed_wires)

    def zs_range(self):
        return range(0, self.config.num_challenges)

    def partial_products_range(self):
        return range(self.config.num_challenges,
                     (self.num_partial_products + 1) * self.config.num_challenges)

    def num_preprocessed_polys(self) -> int:
        return self.sigmas_range().stop

    def num_zs_partial_products_polys(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    def fri_oracles(self) -> list:
        return [
            FriOracleInfo(self.num_preprocessed_polys(), False),
            FriOracleInfo(self.config.num_wires, self.config.zero_knowledge),
            FriOracleInfo(self.num_zs_partial_products_polys()
                          + self.num_all_lookup_polys(),
                          self.config.zero_knowledge),
            FriOracleInfo(self.num_quotient_polys(), self.config.zero_knowledge),
        ]

    def fri_lookup_polys(self) -> list:
        start = self.num_zs_partial_products_polys()
        return FriPolynomialInfo.from_range(
            PlonkOracle.ZS_PARTIAL_PRODUCTS, start,
            start + self.num_all_lookup_polys())

    def fri_all_polys(self) -> list:
        return (
            FriPolynomialInfo.from_range(PlonkOracle.CONSTANTS_SIGMAS, 0,
                                         self.num_preprocessed_polys())
            + FriPolynomialInfo.from_range(PlonkOracle.WIRES, 0, self.config.num_wires)
            + FriPolynomialInfo.from_range(PlonkOracle.ZS_PARTIAL_PRODUCTS, 0,
                                           self.num_zs_partial_products_polys())
            + FriPolynomialInfo.from_range(PlonkOracle.QUOTIENT, 0,
                                           self.num_quotient_polys())
            + self.fri_lookup_polys()
        )

    def fri_zs_polys(self) -> list:
        return FriPolynomialInfo.from_range(PlonkOracle.ZS_PARTIAL_PRODUCTS,
                                            self.zs_range().start, self.zs_range().stop)

    def fri_next_batch_polys(self) -> list:
        """Polys opened at zeta AND g*zeta (circuit_data.rs:566)."""
        return self.fri_zs_polys() + self.fri_lookup_polys()

    def get_fri_instance(self, zeta: np.ndarray) -> FriInstanceInfo:
        """zeta: (2,) extension point (circuit_data.rs:461)."""
        g = gl64.primitive_root_of_unity(self.degree_bits())
        zeta_next = gl64ext.scalar_mul(np.asarray(zeta, dtype=np.uint64), np.uint64(g))
        return FriInstanceInfo(
            oracles=self.fri_oracles(),
            batches=[
                FriBatchInfo(point=np.asarray(zeta, dtype=np.uint64),
                             polynomials=self.fri_all_polys()),
                FriBatchInfo(point=zeta_next,
                             polynomials=self.fri_next_batch_polys()),
            ],
        )


@dataclass
class ProverOnlyCircuitData:
    schedule: object  # WitnessSchedule
    constants_sigmas_commitment: object  # PolynomialBatch
    sigmas: np.ndarray  # (degree, num_routed_wires) sigma values
    subgroup: np.ndarray  # (degree,)
    public_inputs: list  # targets
    circuit_digest: np.ndarray  # (4,)
    lookup_rows: list = None  # (last_lu, last_lut, first_lut) per LUT


@dataclass
class VerifierOnlyCircuitData:
    constants_sigmas_cap: object  # MerkleCap
    circuit_digest: np.ndarray


class CircuitData:
    def __init__(self, prover_only, verifier_only, common):
        self.prover_only = prover_only
        self.verifier_only = verifier_only
        self.common = common

    def prove(self, pw, timing=None, mesh=None):
        """Prove on the device the constants and sigmas were committed on;
        with mesh=, distributed over the mesh's ranks (plonk/prover.py)."""
        from .prover import prove
        return prove(self.prover_only, self.common, pw, timing, mesh=mesh)

    def verify(self, proof_with_pis) -> None:
        from .verifier import verify
        verify(proof_with_pis, self.verifier_only, self.common)
