"""In-circuit verification of multi-table (CTL) STARK proofs.

Twin of reference evm/src/recursive_verifier.rs:265-480 +
cross_table_lookup.rs:480-594, composed monolithically: ONE circuit
replays the whole shared transcript (all trace caps, CTL challenges, then
each table's phases in order), verifies every table's constraints + FRI
in-circuit, and ties the tables together with
verify_cross_table_lookups_circuit.  The reference instead splits one
wrapper circuit per table (chained by challenger-state public inputs) so
tables shrink in parallel; that staged layout sits above this module and
reuses the same per-table pieces (verify_table_circuit takes an explicit
challenger, so callers can chain or share one).

Port note: the port's CTL checks (stark/ctl.py) skip unit-coefficient
multiplies and reuse column evaluations on the prover's device; under the
circuit ctx they keep the reference's operations, so this verifier builds
the same circuit as the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl64
from ..fri.recursive_verifier import (FriChallengesTarget, FriProofTarget,
                                      add_virtual_cap, add_virtual_fri_proof,
                                      verify_fri_proof_circuit)
from ..fri.structure import (FriBatchInfo, FriInstanceInfo, FriOracleInfo,
                             FriPolynomialInfo)
from ..iop.challenger import RecursiveChallenger
from ..plonk.witness import PartialWitness
from ..recursion.ctx import CircuitCtx
from ..recursion.recursive_verifier import _set_cap, _set_ext
from .config import StarkConfig
from .ctl import (ctl_check_vars_for_table, get_grand_product_challenge_set,
                  GrandProductChallenge)
from .multi import MultiProof, MultiTableStarkProof
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

P = gl64.ORDER_INT


@dataclass
class MultiStarkOpeningSetTarget:
    """(evm/src/proof.rs:296 StarkOpeningSetTarget)"""

    local_values: list
    next_values: list
    permutation_ctl_zs: list
    permutation_ctl_zs_next: list
    ctl_zs_last: list  # base targets
    quotient_polys: list

    def to_fri_openings(self, zero: int):
        from ..recursion.recursive_verifier import _Batch, _Openings
        return _Openings(batches=[
            _Batch(values=list(self.local_values)
                   + list(self.permutation_ctl_zs)
                   + list(self.quotient_polys)),
            _Batch(values=list(self.next_values)
                   + list(self.permutation_ctl_zs_next)),
            _Batch(values=[(t, zero) for t in self.ctl_zs_last]),
        ])


@dataclass
class MultiStarkProofTarget:
    trace_cap: list
    permutation_ctl_zs_cap: list
    quotient_polys_cap: list
    openings: MultiStarkOpeningSetTarget
    opening_proof: FriProofTarget


def add_virtual_multi_stark_proof(b, stark: Stark, config: StarkConfig,
                                  degree_bits: int,
                                  num_ctl: int) -> MultiStarkProofTarget:
    """(evm/src/recursive_verifier.rs:549 add_virtual_stark_proof)"""
    fri_params = config.fri_params(degree_bits)
    cap_height = config.fri_config.cap_height
    num_quotient = stark.num_quotient_polys(config)
    num_perm = (stark.num_permutation_batches(config)
                if stark.uses_permutation_args() else 0)
    num_zs = num_perm + num_ctl
    openings = MultiStarkOpeningSetTarget(
        local_values=b.add_virtual_extension_targets(stark.COLUMNS),
        next_values=b.add_virtual_extension_targets(stark.COLUMNS),
        permutation_ctl_zs=b.add_virtual_extension_targets(num_zs),
        permutation_ctl_zs_next=b.add_virtual_extension_targets(num_zs),
        ctl_zs_last=b.add_virtual_targets(num_ctl),
        quotient_polys=b.add_virtual_extension_targets(num_quotient),
    )
    return MultiStarkProofTarget(
        trace_cap=add_virtual_cap(b, cap_height),
        permutation_ctl_zs_cap=add_virtual_cap(b, cap_height),
        quotient_polys_cap=add_virtual_cap(b, cap_height),
        openings=openings,
        opening_proof=add_virtual_fri_proof(
            b, [stark.COLUMNS, num_zs, num_quotient], fri_params),
    )


def _fri_instance_ctl_target(b, stark: Stark, zeta, g: int, num_perm: int,
                             num_ctl: int, config) -> FriInstanceInfo:
    """Circuit twin of multi.fri_instance_ctl (evm/src/stark.rs:145)."""
    num_zs = num_perm + num_ctl
    num_quotient = stark.num_quotient_polys(config)
    oracles = [FriOracleInfo(stark.COLUMNS, False),
               FriOracleInfo(num_zs, False),
               FriOracleInfo(num_quotient, False)]
    trace_info = FriPolynomialInfo.from_range(0, 0, stark.COLUMNS)
    zs_info = FriPolynomialInfo.from_range(1, 0, num_zs)
    ctl_info = FriPolynomialInfo.from_range(1, num_perm, num_zs)
    quotient_info = FriPolynomialInfo.from_range(2, 0, num_quotient)
    zeta_next = b.mul_const_extension(g, zeta)
    last = gl64.pow_scalar(g, P - 2)
    last_t = b.constant_extension(last)
    return FriInstanceInfo(
        oracles=oracles,
        batches=[
            FriBatchInfo(point=zeta,
                         polynomials=trace_info + zs_info + quotient_info),
            FriBatchInfo(point=zeta_next, polynomials=trace_info + zs_info),
            FriBatchInfo(point=last_t, polynomials=ctl_info),
        ])


def verify_table_circuit(b, ch: RecursiveChallenger, stark: Stark,
                         table: int, ctls: list, ctl_challenges_t: list,
                         proof: MultiStarkProofTarget, config: StarkConfig,
                         degree_bits: int) -> None:
    """Replay one table's transcript phases on `ch` and verify its
    constraints (incl. permutation + CTL Z checks) and FRI proof in-circuit
    (evm/src/recursive_verifier.rs:374
    verify_stark_proof_with_challenges_circuit)."""
    degree = 1 << degree_bits
    g = gl64.primitive_root_of_unity(degree_bits)
    ctx = CircuitCtx(b)

    challenge_sets = None
    num_perm = 0
    if stark.uses_permutation_args():
        from .permutation import get_n_permutation_challenge_sets
        challenge_sets = get_n_permutation_challenge_sets(
            ch, config.num_challenges, stark.permutation_batch_size())
        num_perm = stark.num_permutation_batches(config)
    ch.observe_cap(proof.permutation_ctl_zs_cap)
    alphas = ch.get_n_challenges(config.num_challenges)
    ch.observe_cap(proof.quotient_polys_cap)
    zeta = ch.get_extension_challenge()
    zero = b.zero()
    for batch in proof.openings.to_fri_openings(zero).batches:
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

    one_ext = b.one_extension()
    zeta_pow_n = b.exp_power_of_2_extension(zeta, degree_bits)
    z_h_zeta = b.sub_extension(zeta_pow_n, one_ext)
    last = gl64.pow_scalar(g, P - 2)
    z_last = b.sub_extension(zeta, b.constant_extension(last))
    l_first = b.div_extension(
        z_h_zeta,
        b.mul_const_extension(degree, b.sub_extension(zeta, one_ext)))
    l_last = b.div_extension(z_h_zeta, b.mul_const_extension(degree, z_last))

    vars = StarkEvaluationVars(
        local_values=[ctx.wrap(t) for t in proof.openings.local_values],
        next_values=[ctx.wrap(t) for t in proof.openings.next_values],
        public_inputs=[],
    )
    consumer = ConstraintConsumer(
        ctx, [ctx.wrap_base(a) for a in alphas], ctx.wrap(z_last),
        ctx.wrap(l_first), ctx.wrap(l_last))
    stark.eval_generic(ctx, vars, consumer)
    if num_perm:
        from .permutation import eval_permutation_checks
        wrapped_sets = [[(ctx.wrap_base(bt), ctx.wrap_base(gt))
                         for bt, gt in s] for s in challenge_sets]
        eval_permutation_checks(
            ctx, stark, config, vars,
            [ctx.wrap(t) for t in proof.openings.permutation_ctl_zs[:num_perm]],
            [ctx.wrap(t)
             for t in proof.openings.permutation_ctl_zs_next[:num_perm]],
            wrapped_sets, consumer)
    zs_pairs = [(ctx.wrap(lt), ctx.wrap(nt)) for lt, nt in zip(
        proof.openings.permutation_ctl_zs[num_perm:],
        proof.openings.permutation_ctl_zs_next[num_perm:])]
    ctl_vars = ctl_check_vars_for_table(ctls, ctl_challenges_t, table,
                                        zs_pairs)
    from .ctl import eval_cross_table_lookup_checks
    eval_cross_table_lookup_checks(ctx, vars, ctl_vars, consumer)
    vanishing = consumer.accumulators()

    qdf = stark.quotient_degree_factor()
    for i, v in enumerate(vanishing):
        chunk = proof.openings.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = b.zero_extension()
        for c in reversed(chunk):
            acc = b.mul_add_extension(acc, zeta_pow_n, c)
        b.connect_extension(v.t, b.mul_extension(z_h_zeta, acc))

    num_ctl = len(proof.openings.ctl_zs_last)
    verify_fri_proof_circuit(
        b, _fri_instance_ctl_target(b, stark, zeta, g, num_perm, num_ctl,
                                    config),
        proof.openings.to_fri_openings(zero), fri_challenges,
        [proof.trace_cap, proof.permutation_ctl_zs_cap,
         proof.quotient_polys_cap],
        proof.opening_proof, config.fri_params(degree_bits))


def verify_cross_table_lookups_circuit(b, ctls: list, ctl_zs_last_ts: list,
                                       num_challenges: int) -> None:
    """(cross_table_lookup.rs:571) product of looking tables' final Zs ==
    looked table's, connected in-circuit."""
    iters = [iter(ts) for ts in ctl_zs_last_ts]
    for ctl in ctls:
        for _ in range(num_challenges):
            prod = b.one()
            for twc in ctl.looking_tables:
                prod = b.mul(prod, next(iters[twc.table]))
            looked = next(iters[ctl.looked_table.table])
            b.connect(prod, looked)
    for it in iters:
        assert next(it, None) is None


def wrap_ctl_challenges(b, ctl_challenges_raw: list) -> list:
    """Raw target (beta, gamma) challenges -> ctx-element challenges usable
    by GrandProductChallenge.combine under CircuitCtx."""
    ctx = CircuitCtx(b)
    return [GrandProductChallenge(ctx.wrap_base(c.beta),
                                  ctx.wrap_base(c.gamma))
            for c in ctl_challenges_raw]


def verify_multi_proof_circuit(b, starks: list, ctls: list, proof_ts: list,
                               config: StarkConfig,
                               degree_bits: list) -> None:
    """Verify a whole MultiProof inside one circuit: shared transcript
    replay + per-table verification + cross-table product checks
    (evm/src/verifier.rs:29 composed in-circuit)."""
    ch = RecursiveChallenger(b)
    for pt in proof_ts:
        ch.observe_cap(pt.trace_cap)
    raw = get_grand_product_challenge_set(ch, config.num_challenges)
    ctl_challenges_t = wrap_ctl_challenges(b, raw)
    for i, (stark, pt) in enumerate(zip(starks, proof_ts)):
        ch.compact()  # table boundary, mirrors the prover
        verify_table_circuit(b, ch, stark, i, ctls, ctl_challenges_t, pt,
                             config, degree_bits[i])
    verify_cross_table_lookups_circuit(
        b, ctls, [pt.openings.ctl_zs_last for pt in proof_ts],
        config.num_challenges)


def set_multi_stark_proof_target(pw: PartialWitness,
                                 pt: MultiStarkProofTarget,
                                 proof: MultiTableStarkProof) -> None:
    """(evm/src/recursive_verifier.rs:600 set_stark_proof_target)"""
    _set_cap(pw, pt.trace_cap, proof.trace_cap)
    _set_cap(pw, pt.permutation_ctl_zs_cap, proof.permutation_ctl_zs_cap)
    _set_cap(pw, pt.quotient_polys_cap, proof.quotient_polys_cap)
    ot, ov = pt.openings, proof.openings
    for ts, vs in [(ot.local_values, ov.local_values),
                   (ot.next_values, ov.next_values),
                   (ot.permutation_ctl_zs, ov.permutation_ctl_zs),
                   (ot.permutation_ctl_zs_next, ov.permutation_ctl_zs_next),
                   (ot.quotient_polys, ov.quotient_polys)]:
        assert len(ts) == len(vs)
        for t, v in zip(ts, vs):
            _set_ext(pw, t, v)
    for t, v in zip(ot.ctl_zs_last, ov.ctl_zs_last):
        pw.set_target(t, int(v))
    ft, fv = pt.opening_proof, proof.opening_proof
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


def set_multi_proof_targets(pw: PartialWitness, pts: list,
                            proof: MultiProof) -> None:
    for pt, p in zip(pts, proof.stark_proofs):
        set_multi_stark_proof_target(pw, pt, p)
