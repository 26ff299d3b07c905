"""Structural validation of PLONK proofs (twin of reference
plonk/validate_shape.rs:9-74).

Runs before challenge derivation: every array the verifier will index
or iterate is length-checked against the circuit's CommonCircuitData,
so a truncated or padded proof raises a clean ``ShapeError`` instead of
feeding wrong-shaped numpy into the transcript.  The opening *proof*'s
shape is checked inside ``verify_fri_proof`` where the FRI instance is
available (fri/validate_shape.py).
"""

from __future__ import annotations

from ..fri.validate_shape import ShapeError, _cap_height, _ensure


def _opening_len(arr) -> int:
    n = len(arr)
    if n:
        _ensure(arr.shape[-1] == 2, "openings must be extension elements")
    return n


def validate_proof_with_pis_shape(proof_with_pis, common) -> None:
    """proof_with_pis: ProofWithPublicInputs; common: CommonCircuitData
    (reference plonk/validate_shape.rs:9)."""
    _ensure(len(proof_with_pis.public_inputs) == common.num_public_inputs,
            "number of public inputs doesn't match circuit data")
    validate_proof_shape(proof_with_pis.proof, common)


def validate_proof_shape(proof, common) -> None:
    config = common.config
    cap_height = common.fri_params.config.cap_height
    _ensure(_cap_height(proof.wires_cap) == cap_height,
            "wires cap has the wrong height")
    _ensure(_cap_height(proof.plonk_zs_partial_products_cap) == cap_height,
            "Zs/partial-products cap has the wrong height")
    _ensure(_cap_height(proof.quotient_polys_cap) == cap_height,
            "quotient cap has the wrong height")
    o = proof.openings
    _ensure(_opening_len(o.constants) == common.num_constants,
            "wrong number of constant openings")
    _ensure(_opening_len(o.plonk_sigmas) == config.num_routed_wires,
            "wrong number of sigma openings")
    _ensure(_opening_len(o.wires) == config.num_wires,
            "wrong number of wire openings")
    _ensure(_opening_len(o.plonk_zs) == config.num_challenges,
            "wrong number of Z openings")
    _ensure(_opening_len(o.plonk_zs_next) == config.num_challenges,
            "wrong number of next-Z openings")
    _ensure(_opening_len(o.partial_products)
            == config.num_challenges * common.num_partial_products,
            "wrong number of partial-product openings")
    _ensure(_opening_len(o.quotient_polys) == common.num_quotient_polys(),
            "wrong number of quotient openings")
    _ensure(_opening_len(o.lookup_zs) == common.num_all_lookup_polys(),
            "wrong number of lookup-Z openings")
    _ensure(_opening_len(o.lookup_zs_next) == common.num_all_lookup_polys(),
            "wrong number of next-lookup-Z openings")


def validate_stark_proof_shape(stark, proof_with_pis, config,
                               degree_bits: int) -> None:
    """STARK twin (starky has no validate_shape.rs; same rationale —
    stark/verifier.py iterates the opening arrays and zips query data)."""
    proof = proof_with_pis.proof
    cap_height = config.fri_config.cap_height
    _ensure(_cap_height(proof.trace_cap) == cap_height,
            "trace cap has the wrong height")
    _ensure(_cap_height(proof.quotient_polys_cap) == cap_height,
            "quotient cap has the wrong height")
    o = proof.openings
    _ensure(_opening_len(o.local_values) == stark.COLUMNS,
            "wrong number of local-value openings")
    _ensure(_opening_len(o.next_values) == stark.COLUMNS,
            "wrong number of next-value openings")
    _ensure(_opening_len(o.quotient_polys)
            == config.num_challenges * stark.quotient_degree_factor(),
            "wrong number of quotient openings")
    num_perm = (stark.num_permutation_batches(config)
                if stark.uses_permutation_args() else 0)
    _ensure(_opening_len(o.permutation_zs) == num_perm,
            "wrong number of permutation-Z openings")
    _ensure(_opening_len(o.permutation_zs_next) == num_perm,
            "wrong number of next-permutation-Z openings")
    if stark.uses_permutation_args():
        _ensure(proof.permutation_zs_cap is not None
                and _cap_height(proof.permutation_zs_cap) == cap_height,
                "permutation cap missing or wrong height")
