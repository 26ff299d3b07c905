"""In-circuit STARK verification: a PLONK circuit verifying a STARK proof.

Twin of reference starky/src/recursive_verifier.rs:28-334.  Reuses the
recursion machinery: the AIR's `eval_generic` runs against `CircuitCtx`
elements, challenges replay through `RecursiveChallenger`, FRI checks go
through the in-circuit FRI verifier.  Host only: the STARK proof it reads
is host numpy whatever device proved it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl64
from ..fri.recursive_verifier import (FriChallengesTarget, FriProofTarget,
                                      add_virtual_cap, add_virtual_fri_proof,
                                      verify_fri_proof_circuit)
from ..fri.structure import FriBatchInfo, FriInstanceInfo
from ..iop.challenger import RecursiveChallenger
from ..plonk.witness import PartialWitness
from ..recursion.ctx import CircuitCtx
from ..recursion.recursive_verifier import _set_cap, _set_ext
from .config import StarkConfig
from .proof import StarkProofWithPublicInputs
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

P = gl64.ORDER_INT


@dataclass
class StarkOpeningSetTarget:
    local_values: list   # ext targets
    next_values: list
    quotient_polys: list
    permutation_zs: list = None
    permutation_zs_next: list = None

    def __post_init__(self):
        self.permutation_zs = self.permutation_zs or []
        self.permutation_zs_next = self.permutation_zs_next or []

    def to_fri_openings(self):
        from ..recursion.recursive_verifier import _Batch, _Openings
        return _Openings(batches=[
            _Batch(values=list(self.local_values) + list(self.permutation_zs)
                   + list(self.quotient_polys)),
            _Batch(values=list(self.next_values)
                   + list(self.permutation_zs_next)),
        ])


@dataclass
class StarkProofTarget:
    trace_cap: list
    quotient_polys_cap: list
    openings: StarkOpeningSetTarget
    opening_proof: FriProofTarget
    permutation_zs_cap: list = None


@dataclass
class StarkProofWithPisTarget:
    proof: StarkProofTarget
    public_inputs: list


def add_virtual_stark_proof(b, stark: Stark, config: StarkConfig,
                            degree_bits: int) -> StarkProofWithPisTarget:
    fri_params = config.fri_params(degree_bits)
    cap_height = config.fri_config.cap_height
    num_quotient = stark.num_quotient_polys(config)
    uses_perm = stark.uses_permutation_args()
    num_perm = stark.num_permutation_batches(config) if uses_perm else 0
    openings = StarkOpeningSetTarget(
        local_values=b.add_virtual_extension_targets(stark.COLUMNS),
        next_values=b.add_virtual_extension_targets(stark.COLUMNS),
        quotient_polys=b.add_virtual_extension_targets(num_quotient),
        permutation_zs=b.add_virtual_extension_targets(num_perm),
        permutation_zs_next=b.add_virtual_extension_targets(num_perm),
    )
    num_leaves = [stark.COLUMNS]
    if uses_perm:
        num_leaves.append(num_perm)
    num_leaves.append(num_quotient)
    proof = StarkProofTarget(
        trace_cap=add_virtual_cap(b, cap_height),
        quotient_polys_cap=add_virtual_cap(b, cap_height),
        openings=openings,
        opening_proof=add_virtual_fri_proof(b, num_leaves, fri_params),
        permutation_zs_cap=add_virtual_cap(b, cap_height) if uses_perm else None,
    )
    return StarkProofWithPisTarget(
        proof=proof, public_inputs=b.add_virtual_targets(stark.PUBLIC_INPUTS))


def _fri_instance_target(b, stark: Stark, zeta: tuple, g: int,
                         config: StarkConfig) -> FriInstanceInfo:
    """Circuit twin of Stark.fri_instance (stark.rs:88)."""
    from ..fri.structure import FriOracleInfo, FriPolynomialInfo
    oracles = [FriOracleInfo(stark.COLUMNS, False)]
    trace_info = FriPolynomialInfo.from_range(0, 0, stark.COLUMNS)
    perm_info = []
    if stark.uses_permutation_args():
        num_zs = stark.num_permutation_batches(config)
        perm_info = FriPolynomialInfo.from_range(len(oracles), 0, num_zs)
        oracles.append(FriOracleInfo(num_zs, False))
    num_quotient = stark.num_quotient_polys(config)
    quotient_info = FriPolynomialInfo.from_range(len(oracles), 0, num_quotient)
    oracles.append(FriOracleInfo(num_quotient, False))
    zeta_next = b.mul_const_extension(g, zeta)
    return FriInstanceInfo(
        oracles=oracles,
        batches=[
            FriBatchInfo(point=zeta,
                         polynomials=trace_info + perm_info + quotient_info),
            FriBatchInfo(point=zeta_next, polynomials=trace_info + perm_info),
        ])


def verify_stark_proof_circuit(b, stark: Stark,
                               proof_t: StarkProofWithPisTarget,
                               config: StarkConfig, degree_bits: int) -> None:
    """starky/src/recursive_verifier.rs:28."""
    proof = proof_t.proof
    degree = 1 << degree_bits
    g = gl64.primitive_root_of_unity(degree_bits)

    # transcript replay (starky/src/get_challenges.rs)
    ch = RecursiveChallenger(b)
    ch.observe_cap(proof.trace_cap)
    challenge_sets = None
    if stark.uses_permutation_args():
        from .permutation import get_n_permutation_challenge_sets
        challenge_sets = get_n_permutation_challenge_sets(
            ch, config.num_challenges, stark.permutation_batch_size())
        ch.observe_cap(proof.permutation_zs_cap)
    alphas = ch.get_n_challenges(config.num_challenges)
    ch.observe_cap(proof.quotient_polys_cap)
    zeta = ch.get_extension_challenge()
    for batch in proof.openings.to_fri_openings().batches:
        for v in batch.values:
            ch.observe_extension_element(v)
    fri_alpha = ch.get_extension_challenge()
    betas = []
    for cap in proof.opening_proof.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        betas.append(ch.get_extension_challenge())
    for c in proof.opening_proof.final_poly:
        ch.observe_extension_element(c)
    ch.observe_element(proof.opening_proof.pow_witness)
    fri_pow_response = ch.get_challenge()
    indices = ch.get_n_challenges(config.fri_config.num_query_rounds)
    fri_challenges = FriChallengesTarget(fri_alpha, betas, fri_pow_response,
                                         indices)

    # filters at zeta, in-circuit
    ctx = CircuitCtx(b)
    one_ext = b.one_extension()
    zeta_pow_n = b.exp_power_of_2_extension(zeta, degree_bits)
    z_h_zeta = b.sub_extension(zeta_pow_n, one_ext)
    last = gl64.pow_scalar(g, P - 2)  # g^{n-1} = g^{-1}
    last_ext = b.constant_extension(last)
    z_last = b.sub_extension(zeta, last_ext)
    l_first = b.div_extension(
        z_h_zeta, b.mul_const_extension(degree, b.sub_extension(zeta, one_ext)))
    l_last = b.div_extension(
        z_h_zeta, b.mul_const_extension(degree, z_last))

    vars = StarkEvaluationVars(
        local_values=[ctx.wrap(t) for t in proof.openings.local_values],
        next_values=[ctx.wrap(t) for t in proof.openings.next_values],
        public_inputs=[ctx.wrap_base(t) for t in proof_t.public_inputs],
    )
    consumer = ConstraintConsumer(
        ctx, [ctx.wrap_base(a) for a in alphas], ctx.wrap(z_last),
        ctx.wrap(l_first), ctx.wrap(l_last))
    stark.eval_generic(ctx, vars, consumer)
    if stark.uses_permutation_args():
        from .permutation import eval_permutation_checks
        wrapped_sets = [[(ctx.wrap_base(bt), ctx.wrap_base(gt))
                         for bt, gt in s] for s in challenge_sets]
        eval_permutation_checks(
            ctx, stark, config, vars,
            [ctx.wrap(t) for t in proof.openings.permutation_zs],
            [ctx.wrap(t) for t in proof.openings.permutation_zs_next],
            wrapped_sets, consumer)
    vanishing = consumer.accumulators()

    # vanishing_i(zeta) == Z_H(zeta) * reduce(t_chunks_i, zeta^n)
    qdf = stark.quotient_degree_factor()
    for i, v in enumerate(vanishing):
        chunk = proof.openings.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = b.zero_extension()
        for c in reversed(chunk):
            acc = b.mul_add_extension(acc, zeta_pow_n, c)
        b.connect_extension(v.t, b.mul_extension(z_h_zeta, acc))

    caps = [proof.trace_cap]
    if stark.uses_permutation_args():
        caps.append(proof.permutation_zs_cap)
    caps.append(proof.quotient_polys_cap)
    verify_fri_proof_circuit(
        b, _fri_instance_target(b, stark, zeta, g, config),
        proof.openings.to_fri_openings(), fri_challenges,
        caps, proof.opening_proof, config.fri_params(degree_bits))


def set_stark_proof_target(pw: PartialWitness, pt: StarkProofWithPisTarget,
                           proof_with_pis: StarkProofWithPublicInputs) -> None:
    proof = proof_with_pis.proof
    for t, v in zip(pt.public_inputs, proof_with_pis.public_inputs):
        pw.set_target(t, int(v))
    _set_cap(pw, pt.proof.trace_cap, proof.trace_cap)
    _set_cap(pw, pt.proof.quotient_polys_cap, proof.quotient_polys_cap)
    if pt.proof.permutation_zs_cap is not None:
        _set_cap(pw, pt.proof.permutation_zs_cap, proof.permutation_zs_cap)
    ot, ov = pt.proof.openings, proof.openings
    for ts, vs in [(ot.local_values, ov.local_values),
                   (ot.next_values, ov.next_values),
                   (ot.quotient_polys, ov.quotient_polys),
                   (ot.permutation_zs, ov.permutation_zs),
                   (ot.permutation_zs_next, ov.permutation_zs_next)]:
        assert len(ts) == len(vs)
        for t, v in zip(ts, vs):
            _set_ext(pw, t, v)
    ft, fv = pt.proof.opening_proof, proof.opening_proof
    pw.set_target(ft.pow_witness, int(fv.pow_witness))
    for t, v in zip(ft.final_poly, fv.final_poly):
        _set_ext(pw, t, v)
    for cap_t, cap_v in zip(ft.commit_phase_merkle_caps,
                            fv.commit_phase_merkle_caps):
        _set_cap(pw, cap_t, cap_v)
    for round_t, round_v in zip(ft.query_round_proofs, fv.query_round_proofs):
        for (leaves_t, mp_t), (leaves_v, mp_v) in zip(
                round_t.initial_trees_proof.evals_proofs,
                round_v.initial_trees_proof.evals_proofs):
            for t, v in zip(leaves_t, leaves_v):
                pw.set_target(t, int(v))
            for ht, hv in zip(mp_t.siblings, mp_v.siblings):
                for t, v in zip(ht, hv):
                    pw.set_target(t, int(v))
        for step_t, step_v in zip(round_t.steps, round_v.steps):
            for t, v in zip(step_t.evals, step_v.evals):
                _set_ext(pw, t, v)
            for ht, hv in zip(step_t.merkle_proof.siblings,
                              step_v.merkle_proof.siblings):
                for t, v in zip(ht, hv):
                    pw.set_target(t, int(v))
