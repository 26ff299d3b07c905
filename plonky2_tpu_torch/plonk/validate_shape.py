"""Structural validation of STARK proofs before any field or hash work.

Every array the verifier will index or iterate is length-checked against
the AIR and config, so a truncated or padded proof raises a clean
``ShapeError`` instead of feeding wrong-shaped numpy into the transcript.
The opening proof's shape is checked inside ``verify_fri_proof``.
"""

from __future__ import annotations

from ..fri.validate_shape import _cap_height, _ensure


def _opening_len(arr) -> int:
    n = len(arr)
    if n:
        _ensure(arr.shape[-1] == 2, "openings must be extension elements")
    return n


def validate_stark_proof_shape(stark, proof_with_pis, config,
                               degree_bits: int) -> None:
    """starky has no validate_shape.rs; same rationale as the plonk one."""
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
