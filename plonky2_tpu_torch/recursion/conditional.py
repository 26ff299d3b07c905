"""Conditional recursive verification: verify proof0 if b else proof1.

Twin of reference recursion/conditional_recursive_verifier.rs:23-408.  All
proof targets are select()ed pairwise, then the selected proof is verified
once — so the circuit size is one verifier plus O(proof size) selects.
Port change: the ``_or_dummy`` form builds and proves its dummy circuit on
the ``device`` the caller passes.
"""

from __future__ import annotations

from ..fri.recursive_verifier import (FriInitialTreeProofTarget,
                                      FriProofTarget, FriQueryRoundTarget,
                                      FriQueryStepTarget, MerkleProofTarget)
from .recursive_verifier import (OpeningSetTarget, ProofTarget,
                                 ProofWithPublicInputsTarget,
                                 VerifierCircuitTarget, verify_proof_circuit)


def select_vec(b, cond, v0, v1):
    return [b.select(cond, t0, t1) for t0, t1 in zip(v0, v1)]


def select_ext_vec(b, cond, v0, v1):
    return [b.select_ext(cond, t0, t1) for t0, t1 in zip(v0, v1)]


def select_hash(b, cond, h0, h1):
    return select_vec(b, cond, h0, h1)


def select_cap(b, cond, c0, c1):
    return [select_hash(b, cond, h0, h1) for h0, h1 in zip(c0, c1)]


def select_merkle_proof(b, cond, p0, p1):
    return MerkleProofTarget(select_cap(b, cond, p0.siblings, p1.siblings))


def select_opening_set(b, cond, o0: OpeningSetTarget, o1: OpeningSetTarget):
    sel = lambda v0, v1: select_ext_vec(b, cond, v0, v1)  # noqa: E731
    return OpeningSetTarget(
        constants=sel(o0.constants, o1.constants),
        plonk_sigmas=sel(o0.plonk_sigmas, o1.plonk_sigmas),
        wires=sel(o0.wires, o1.wires),
        plonk_zs=sel(o0.plonk_zs, o1.plonk_zs),
        plonk_zs_next=sel(o0.plonk_zs_next, o1.plonk_zs_next),
        partial_products=sel(o0.partial_products, o1.partial_products),
        quotient_polys=sel(o0.quotient_polys, o1.quotient_polys),
        lookup_zs=sel(o0.lookup_zs, o1.lookup_zs),
        lookup_zs_next=sel(o0.lookup_zs_next, o1.lookup_zs_next),
    )


def select_opening_proof(b, cond, p0: FriProofTarget, p1: FriProofTarget):
    rounds = []
    for r0, r1 in zip(p0.query_round_proofs, p1.query_round_proofs):
        evals_proofs = [
            (select_vec(b, cond, l0, l1), select_merkle_proof(b, cond, m0, m1))
            for (l0, m0), (l1, m1) in zip(r0.initial_trees_proof.evals_proofs,
                                          r1.initial_trees_proof.evals_proofs)]
        steps = [FriQueryStepTarget(
            evals=select_ext_vec(b, cond, s0.evals, s1.evals),
            merkle_proof=select_merkle_proof(b, cond, s0.merkle_proof,
                                             s1.merkle_proof))
            for s0, s1 in zip(r0.steps, r1.steps)]
        rounds.append(FriQueryRoundTarget(
            FriInitialTreeProofTarget(evals_proofs), steps))
    return FriProofTarget(
        commit_phase_merkle_caps=[select_cap(b, cond, c0, c1)
                                  for c0, c1 in zip(p0.commit_phase_merkle_caps,
                                                    p1.commit_phase_merkle_caps)],
        query_round_proofs=rounds,
        final_poly=select_ext_vec(b, cond, p0.final_poly, p1.final_poly),
        pow_witness=b.select(cond, p0.pow_witness, p1.pow_witness),
    )


def select_proof_with_pis(b, cond, p0: ProofWithPublicInputsTarget,
                          p1: ProofWithPublicInputsTarget):
    return ProofWithPublicInputsTarget(
        proof=ProofTarget(
            wires_cap=select_cap(b, cond, p0.proof.wires_cap, p1.proof.wires_cap),
            plonk_zs_partial_products_cap=select_cap(
                b, cond, p0.proof.plonk_zs_partial_products_cap,
                p1.proof.plonk_zs_partial_products_cap),
            quotient_polys_cap=select_cap(
                b, cond, p0.proof.quotient_polys_cap, p1.proof.quotient_polys_cap),
            openings=select_opening_set(b, cond, p0.proof.openings,
                                        p1.proof.openings),
            opening_proof=select_opening_proof(b, cond, p0.proof.opening_proof,
                                               p1.proof.opening_proof),
        ),
        public_inputs=select_vec(b, cond, p0.public_inputs, p1.public_inputs),
    )


def conditionally_verify_proof(b, condition, proof0, verifier_data0,
                               proof1, verifier_data1, inner_common) -> None:
    """Verify proof0 if condition else proof1 (both with the same
    CommonCircuitData)."""
    b.assert_bool(condition)
    selected = select_proof_with_pis(b, condition, proof0, proof1)
    selected_vd = VerifierCircuitTarget(
        constants_sigmas_cap=select_cap(b, condition,
                                        verifier_data0.constants_sigmas_cap,
                                        verifier_data1.constants_sigmas_cap),
        circuit_digest=select_hash(b, condition, verifier_data0.circuit_digest,
                                   verifier_data1.circuit_digest),
    )
    verify_proof_circuit(b, selected, selected_vd, inner_common)


def conditionally_verify_proof_or_dummy(b, condition, proof_with_pis,
                                        inner_verifier_data,
                                        inner_common, device=None) -> None:
    """Verify the given proof if condition, else a build-time dummy proof
    (conditional_recursive_verifier.rs:53), proved on ``device``."""
    from .dummy import dummy_proof_and_vk_targets
    dummy_pt, dummy_vdt = dummy_proof_and_vk_targets(b, inner_common, device)
    conditionally_verify_proof(b, condition, proof_with_pis,
                               inner_verifier_data, dummy_pt, dummy_vdt,
                               inner_common)
