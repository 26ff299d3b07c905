"""STARK verifier (twin of reference starky/src/verifier.rs:21 and
starky/src/get_challenges.rs)."""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..field.gl64ext import E2
from ..fri.verifier import fri_challenges, verify_fri_proof
from ..iop.challenger import Challenger, permutation_for
from ..plonk.gates.base import ExtCtx
from .config import StarkConfig
from .proof import StarkProofChallenges, StarkProofWithPublicInputs
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

P = gl64.ORDER_INT


def get_challenges(stark: Stark, proof_with_pis: StarkProofWithPublicInputs,
                   config: StarkConfig, degree_bits: int) -> StarkProofChallenges:
    proof = proof_with_pis.proof
    challenger = Challenger(permutation_for(config.hasher))
    challenger.observe_cap(proof.trace_cap)
    challenge_sets = None
    if stark.uses_permutation_args():
        from .permutation import get_n_permutation_challenge_sets
        challenge_sets = get_n_permutation_challenge_sets(
            challenger, config.num_challenges, stark.permutation_batch_size())
        challenger.observe_cap(proof.permutation_zs_cap)
    alphas = challenger.get_n_challenges(config.num_challenges)
    challenger.observe_cap(proof.quotient_polys_cap)
    zeta = challenger.get_extension_challenge()
    for batch in proof.openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)
    fri = fri_challenges(challenger, proof.opening_proof.commit_phase_merkle_caps,
                         proof.opening_proof.final_poly,
                         proof.opening_proof.pow_witness,
                         degree_bits, config.fri_config)
    return StarkProofChallenges(alphas, zeta, fri, challenge_sets)


def verify_stark_proof(stark: Stark, proof_with_pis: StarkProofWithPublicInputs,
                       config: StarkConfig, degree_bits: int) -> None:
    proof = proof_with_pis.proof
    # structural checks first (plonk/validate_shape.py rationale)
    from ..plonk.validate_shape import validate_stark_proof_shape
    validate_stark_proof_shape(stark, proof_with_pis, config, degree_bits)
    challenges = get_challenges(stark, proof_with_pis, config, degree_bits)
    openings = proof.openings
    ctx = ExtCtx()
    zeta = E2(challenges.stark_zeta)
    degree = 1 << degree_bits
    g = gl64.primitive_root_of_unity(degree_bits)

    # filters at zeta
    zeta_pow_n = zeta.pow_const(degree)
    z_h_zeta = zeta_pow_n - ctx.one()
    last = pow(g, P - 2, P)  # g^{n-1} = g^{-1}
    z_last = zeta - ctx.constant(last)
    l_first = z_h_zeta * ((zeta - ctx.one()) * ctx.constant(degree)).inv()
    l_last = z_h_zeta * ((zeta - ctx.constant(last)) * ctx.constant(degree)).inv()

    vars = StarkEvaluationVars(
        local_values=[E2(v) for v in openings.local_values],
        next_values=[E2(v) for v in openings.next_values],
        public_inputs=[ctx.constant(int(pi))
                       for pi in proof_with_pis.public_inputs],
    )
    consumer = ConstraintConsumer(ctx, challenges.stark_alphas, z_last,
                                  l_first, l_last)
    stark.eval_generic(ctx, vars, consumer)
    if stark.uses_permutation_args():
        from .permutation import eval_permutation_checks
        eval_permutation_checks(
            ctx, stark, config, vars,
            [E2(v) for v in openings.permutation_zs],
            [E2(v) for v in openings.permutation_zs_next],
            challenges.permutation_challenge_sets, consumer)
    vanishing = consumer.accumulators()

    qdf = stark.quotient_degree_factor()
    for i, v in enumerate(vanishing):
        chunk = openings.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = ctx.zero()
        for c in chunk[::-1]:
            acc = acc * zeta_pow_n + E2(c)
        assert v.equals(z_h_zeta * acc), f"STARK vanishing check failed ({i})"

    caps = [proof.trace_cap]
    if stark.uses_permutation_args():
        caps.append(proof.permutation_zs_cap)
    caps.append(proof.quotient_polys_cap)
    verify_fri_proof(
        stark.fri_instance(challenges.stark_zeta, g, config),
        openings.to_fri_openings(),
        challenges.fri_challenges,
        caps,
        proof.opening_proof,
        config.fri_params(degree_bits),
    )
