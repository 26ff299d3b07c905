"""PLONK verifier (twin of reference plonk/verifier.rs:15-120 and
plonk/get_challenges.rs:26).  Host-side: verification is milliseconds of
extension-scalar work and drives the FRI query checks."""

from __future__ import annotations

import numpy as np

from ..field import gl64, gl64ext
from ..field.gl64ext import E2
from ..fri.verifier import fri_challenges, verify_fri_proof
from ..hash.hashing import hash_no_pad_np
from ..iop.challenger import Challenger, permutation_for
from .circuit_data import CommonCircuitData, VerifierOnlyCircuitData
from .gates.base import EvalVars, ExtCtx
from .proof import ProofChallenges, ProofWithPublicInputs
from .vanishing import eval_vanishing_poly

P = gl64.ORDER_INT


def get_challenges(proof_with_pis: ProofWithPublicInputs,
                   public_inputs_hash: np.ndarray,
                   circuit_digest: np.ndarray,
                   common: CommonCircuitData) -> ProofChallenges:
    proof = proof_with_pis.proof
    nc = common.config.num_challenges
    challenger = Challenger(permutation_for(common.config.hasher))
    challenger.observe_hash(circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(proof.wires_cap)
    plonk_betas = challenger.get_n_challenges(nc)
    plonk_gammas = challenger.get_n_challenges(nc)
    if common.has_lookup():
        extra = challenger.get_n_challenges(2 * nc)
        plonk_deltas = np.concatenate([plonk_betas, plonk_gammas, extra])
    else:
        plonk_deltas = np.zeros(0, dtype=np.uint64)
    challenger.observe_cap(proof.plonk_zs_partial_products_cap)
    plonk_alphas = challenger.get_n_challenges(nc)
    challenger.observe_cap(proof.quotient_polys_cap)
    plonk_zeta = challenger.get_extension_challenge()
    for batch in proof.openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)
    fri = fri_challenges(challenger, proof.opening_proof.commit_phase_merkle_caps,
                         proof.opening_proof.final_poly,
                         proof.opening_proof.pow_witness,
                         common.degree_bits(), common.config.fri_config)
    return ProofChallenges(plonk_betas, plonk_gammas, plonk_alphas,
                           plonk_zeta, fri, plonk_deltas)


def verify(proof_with_pis: ProofWithPublicInputs,
           verifier_data: VerifierOnlyCircuitData,
           common: CommonCircuitData) -> None:
    proof = proof_with_pis.proof
    # structural checks first: a malformed proof must be a clean reject,
    # not a numpy error (reference plonk/validate_shape.rs:9)
    from .validate_shape import validate_proof_with_pis_shape
    validate_proof_with_pis_shape(proof_with_pis, common)
    public_inputs_hash = hash_no_pad_np(
        gl64.to_canonical(np.asarray(proof_with_pis.public_inputs, dtype=np.uint64)))
    challenges = get_challenges(proof_with_pis, public_inputs_hash,
                                verifier_data.circuit_digest, common)
    verify_with_challenges(proof, public_inputs_hash, challenges,
                           verifier_data, common)


def verify_with_challenges(proof, public_inputs_hash, challenges: ProofChallenges,
                           verifier_data, common: CommonCircuitData) -> None:
    openings = proof.openings
    ctx = ExtCtx()
    zeta = E2(challenges.plonk_zeta)
    n = common.degree()

    vars = EvalVars(
        local_constants=[E2(v) for v in openings.constants],
        local_wires=[E2(v) for v in openings.wires],
        public_inputs_hash=[ctx.constant(int(h)) for h in public_inputs_hash],
    )
    local_zs = [E2(v) for v in openings.plonk_zs]
    next_zs = [E2(v) for v in openings.plonk_zs_next]
    partial_products = [E2(v) for v in openings.partial_products]
    s_sigmas = [E2(v) for v in openings.plonk_sigmas]
    local_lookup_zs = [E2(v) for v in openings.lookup_zs]
    next_lookup_zs = [E2(v) for v in openings.lookup_zs_next]

    # L_0(zeta) = (zeta^n - 1) / (n * (zeta - 1))
    zeta_pow_n = zeta.pow_const(n)
    z_h_zeta = zeta_pow_n - ctx.one()
    l_0 = z_h_zeta * ((zeta - ctx.one()) * ctx.constant(n)).inv()

    vanishing = eval_vanishing_poly(
        ctx, common, zeta, vars, local_zs, next_zs, partial_products, s_sigmas,
        challenges.plonk_betas, challenges.plonk_gammas, challenges.plonk_alphas,
        l_0, local_lookup_zs=local_lookup_zs, next_lookup_zs=next_lookup_zs,
        deltas=challenges.plonk_deltas)

    # vanishing_i(zeta) == Z_H(zeta) * reduce(t_chunks_i, zeta^n)
    qdf = common.quotient_degree_factor
    for i, v in enumerate(vanishing):
        chunk = openings.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = ctx.zero()
        for c in chunk[::-1]:
            acc = acc * zeta_pow_n + E2(c)
        assert v.equals(z_h_zeta * acc), \
            f"vanishing check failed for challenge {i}"

    merkle_caps = [
        verifier_data.constants_sigmas_cap,
        proof.wires_cap,
        proof.plonk_zs_partial_products_cap,
        proof.quotient_polys_cap,
    ]
    verify_fri_proof(
        common.get_fri_instance(challenges.plonk_zeta),
        openings.to_fri_openings(),
        challenges.fri_challenges,
        merkle_caps,
        proof.opening_proof,
        common.fri_params,
    )
