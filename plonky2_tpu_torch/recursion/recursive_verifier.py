"""Recursive proof verification: a circuit that verifies another proof.

Twin of reference recursion/recursive_verifier.rs:17-695 plus the circuit
halves of plonk/get_challenges.rs:107 and fri target allocation.  The
vanishing-polynomial evaluation reuses the field-polymorphic
`eval_vanishing_poly` with `CircuitCtx`, so gate constraint logic is written
once for prover, verifier, and recursive verifier.  Host only: caps and
proofs are read as host numpy (the port's ``MerkleCap.data`` and proof
fields are numpy already), and the wrapper proves on the device its
circuit was built on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gl64
from ..fri.recursive_verifier import (FriChallengesTarget, FriProofTarget,
                                      add_virtual_cap, add_virtual_fri_proof,
                                      verify_fri_proof_circuit)
from ..fri.structure import FriBatchInfo, FriInstanceInfo
from ..iop.challenger import RecursiveChallenger
from ..plonk.gadgets import ReducingFactorTarget
from ..plonk.gates.base import EvalVars
from ..plonk.proof import ProofWithPublicInputs
from ..plonk.vanishing import eval_vanishing_poly
from ..plonk.witness import PartialWitness
from .ctx import CircuitCtx

P = gl64.ORDER_INT


# -- target containers ---------------------------------------------------------

@dataclass
class OpeningSetTarget:
    constants: list
    plonk_sigmas: list
    wires: list
    plonk_zs: list
    plonk_zs_next: list
    partial_products: list
    quotient_polys: list
    lookup_zs: list = None
    lookup_zs_next: list = None

    def __post_init__(self):
        self.lookup_zs = self.lookup_zs or []
        self.lookup_zs_next = self.lookup_zs_next or []

    def to_fri_openings(self):
        zeta_batch = _Batch(values=(list(self.constants) + list(self.plonk_sigmas)
                                    + list(self.wires) + list(self.plonk_zs)
                                    + list(self.partial_products)
                                    + list(self.quotient_polys)
                                    + list(self.lookup_zs)))
        next_batch = _Batch(values=list(self.plonk_zs_next)
                            + list(self.lookup_zs_next))
        return _Openings(batches=[zeta_batch, next_batch])


@dataclass
class _Batch:
    values: list


@dataclass
class _Openings:
    batches: list


@dataclass
class ProofTarget:
    wires_cap: list
    plonk_zs_partial_products_cap: list
    quotient_polys_cap: list
    openings: OpeningSetTarget
    opening_proof: FriProofTarget


@dataclass
class ProofWithPublicInputsTarget:
    proof: ProofTarget
    public_inputs: list


@dataclass
class VerifierCircuitTarget:
    constants_sigmas_cap: list
    circuit_digest: list  # 4 targets


# -- virtual-target allocation (recursive_verifier.rs:134-200) -----------------

def add_virtual_verifier_data(b, cap_height: int) -> VerifierCircuitTarget:
    return VerifierCircuitTarget(
        constants_sigmas_cap=add_virtual_cap(b, cap_height),
        circuit_digest=b.add_virtual_targets(4))


def add_virtual_proof_with_pis(b, common) -> ProofWithPublicInputsTarget:
    config = common.config
    cap_height = config.fri_config.cap_height
    fri_params = common.fri_params

    openings = OpeningSetTarget(
        constants=b.add_virtual_extension_targets(common.num_constants),
        plonk_sigmas=b.add_virtual_extension_targets(config.num_routed_wires),
        wires=b.add_virtual_extension_targets(config.num_wires),
        plonk_zs=b.add_virtual_extension_targets(config.num_challenges),
        plonk_zs_next=b.add_virtual_extension_targets(config.num_challenges),
        partial_products=b.add_virtual_extension_targets(
            config.num_challenges * common.num_partial_products),
        quotient_polys=b.add_virtual_extension_targets(common.num_quotient_polys()),
        lookup_zs=b.add_virtual_extension_targets(common.num_all_lookup_polys()),
        lookup_zs_next=b.add_virtual_extension_targets(
            common.num_all_lookup_polys()),
    )
    num_leaves_per_oracle = [
        common.num_preprocessed_polys(),
        config.num_wires,
        common.num_zs_partial_products_polys() + common.num_all_lookup_polys(),
        common.num_quotient_polys(),
    ]
    proof = ProofTarget(
        wires_cap=add_virtual_cap(b, cap_height),
        plonk_zs_partial_products_cap=add_virtual_cap(b, cap_height),
        quotient_polys_cap=add_virtual_cap(b, cap_height),
        openings=openings,
        opening_proof=add_virtual_fri_proof(b, num_leaves_per_oracle, fri_params),
    )
    return ProofWithPublicInputsTarget(
        proof=proof, public_inputs=b.add_virtual_targets(common.num_public_inputs))


# -- transcript replay (get_challenges.rs:107 circuit half) ---------------------

@dataclass
class ProofChallengesTarget:
    plonk_betas: list
    plonk_gammas: list
    plonk_alphas: list
    plonk_zeta: tuple
    fri_challenges: FriChallengesTarget
    plonk_deltas: list = None


def get_challenges_circuit(b, proof_t: ProofTarget, public_inputs_hash: list,
                           circuit_digest: list, common) -> ProofChallengesTarget:
    nc = common.config.num_challenges
    ch = RecursiveChallenger(b)
    ch.observe_hash(circuit_digest)
    ch.observe_hash(public_inputs_hash)
    ch.observe_cap(proof_t.wires_cap)
    plonk_betas = ch.get_n_challenges(nc)
    plonk_gammas = ch.get_n_challenges(nc)
    plonk_deltas = (plonk_betas + plonk_gammas + ch.get_n_challenges(2 * nc)) \
        if common.has_lookup() else []
    ch.observe_cap(proof_t.plonk_zs_partial_products_cap)
    plonk_alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof_t.quotient_polys_cap)
    plonk_zeta = ch.get_extension_challenge()

    for batch in proof_t.openings.to_fri_openings().batches:
        for v in batch.values:
            ch.observe_extension_element(v)

    fri_alpha = ch.get_extension_challenge()
    betas = []
    for cap in proof_t.opening_proof.commit_phase_merkle_caps:
        ch.observe_cap(cap)
        betas.append(ch.get_extension_challenge())
    for c in proof_t.opening_proof.final_poly:
        ch.observe_extension_element(c)
    ch.observe_element(proof_t.opening_proof.pow_witness)
    fri_pow_response = ch.get_challenge()
    indices = ch.get_n_challenges(common.config.fri_config.num_query_rounds)

    return ProofChallengesTarget(
        plonk_betas, plonk_gammas, plonk_alphas, plonk_zeta,
        FriChallengesTarget(fri_alpha, betas, fri_pow_response, indices),
        plonk_deltas)


# -- verification ----------------------------------------------------------------

def get_fri_instance_target(b, common, zeta: tuple) -> FriInstanceInfo:
    g = gl64.primitive_root_of_unity(common.degree_bits())
    zeta_next = b.mul_const_extension(g, zeta)
    return FriInstanceInfo(
        oracles=common.fri_oracles(),
        batches=[
            FriBatchInfo(point=zeta, polynomials=common.fri_all_polys()),
            FriBatchInfo(point=zeta_next, polynomials=common.fri_zs_polys()),
        ])


def verify_proof_circuit(b, proof_with_pis_t: ProofWithPublicInputsTarget,
                         inner_verifier_data: VerifierCircuitTarget,
                         inner_common) -> None:
    """CircuitBuilder::verify_proof (recursive_verifier.rs:17)."""
    assert len(proof_with_pis_t.public_inputs) == inner_common.num_public_inputs
    public_inputs_hash = b.hash_n_to_hash_no_pad(
        list(proof_with_pis_t.public_inputs))
    challenges = get_challenges_circuit(
        b, proof_with_pis_t.proof, public_inputs_hash,
        inner_verifier_data.circuit_digest, inner_common)
    _verify_with_challenges(b, proof_with_pis_t.proof, public_inputs_hash,
                            challenges, inner_verifier_data, inner_common)


def _verify_with_challenges(b, proof: ProofTarget, public_inputs_hash: list,
                            challenges: ProofChallengesTarget,
                            inner_verifier_data, common) -> None:
    ctx = CircuitCtx(b)
    zeta = challenges.plonk_zeta
    zeta_w = ctx.wrap(zeta)
    n = common.degree()

    openings = proof.openings
    vars = EvalVars(
        local_constants=[ctx.wrap(t) for t in openings.constants],
        local_wires=[ctx.wrap(t) for t in openings.wires],
        public_inputs_hash=[ctx.wrap_base(t) for t in public_inputs_hash],
    )
    local_zs = [ctx.wrap(t) for t in openings.plonk_zs]
    next_zs = [ctx.wrap(t) for t in openings.plonk_zs_next]
    partial_products = [ctx.wrap(t) for t in openings.partial_products]
    s_sigmas = [ctx.wrap(t) for t in openings.plonk_sigmas]
    betas = [ctx.wrap_base(t) for t in challenges.plonk_betas]
    gammas = [ctx.wrap_base(t) for t in challenges.plonk_gammas]
    alphas = [ctx.wrap_base(t) for t in challenges.plonk_alphas]
    local_lookup_zs = [ctx.wrap(t) for t in openings.lookup_zs]
    next_lookup_zs = [ctx.wrap(t) for t in openings.lookup_zs_next]
    deltas = [ctx.wrap_base(t) for t in (challenges.plonk_deltas or [])]

    # L_0(zeta) = (zeta^n - 1) / (n * (zeta - 1))
    zeta_pow_deg = b.exp_power_of_2_extension(zeta, common.degree_bits())
    one_ext = b.one_extension()
    z_h_zeta = b.sub_extension(zeta_pow_deg, one_ext)
    denom = b.mul_const_extension(n, b.sub_extension(zeta, one_ext))
    l_0 = b.div_extension(z_h_zeta, denom)

    vanishing = eval_vanishing_poly(
        ctx, common, zeta_w, vars, local_zs, next_zs, partial_products,
        s_sigmas, betas, gammas, alphas, ctx.wrap(l_0),
        local_lookup_zs=local_lookup_zs, next_lookup_zs=next_lookup_zs,
        deltas=deltas)

    # vanishing_i(zeta) == Z_H(zeta) * reduce(t_chunks_i, zeta^n)
    qdf = common.quotient_degree_factor
    for i, v in enumerate(vanishing):
        chunk = openings.quotient_polys[i * qdf:(i + 1) * qdf]
        scale = ReducingFactorTarget(zeta_pow_deg)
        recombined = scale.reduce(chunk, b)
        computed = b.mul_extension(z_h_zeta, recombined)
        b.connect_extension(v.t, computed)

    merkle_caps = [
        inner_verifier_data.constants_sigmas_cap,
        proof.wires_cap,
        proof.plonk_zs_partial_products_cap,
        proof.quotient_polys_cap,
    ]
    fri_instance = get_fri_instance_target(b, common, zeta)
    verify_fri_proof_circuit(
        b, fri_instance, openings.to_fri_openings(), challenges.fri_challenges,
        merkle_caps, proof.opening_proof, common.fri_params)


# -- witness filling (fri/witness_util.rs twin) ----------------------------------

def _set_ext(pw: PartialWitness, et: tuple, value) -> None:
    pw.set_target(et[0], int(value[0]))
    pw.set_target(et[1], int(value[1]))


def _set_cap(pw: PartialWitness, cap_t: list, cap) -> None:
    data = cap.data if hasattr(cap, "data") else np.asarray(cap)
    for ht, hv in zip(cap_t, data):
        for t, v in zip(ht, hv):
            pw.set_target(t, int(v))


def set_verifier_data_target(pw: PartialWitness, vdt: VerifierCircuitTarget,
                             verifier_data) -> None:
    _set_cap(pw, vdt.constants_sigmas_cap, verifier_data.constants_sigmas_cap)
    for t, v in zip(vdt.circuit_digest, verifier_data.circuit_digest):
        pw.set_target(t, int(v))


def set_proof_with_pis_target(pw: PartialWitness,
                              pt: ProofWithPublicInputsTarget,
                              proof_with_pis: ProofWithPublicInputs) -> None:
    fill_proof_with_pis_target(pw.set_target, pt, proof_with_pis)


def fill_proof_with_pis_target(set_target, pt: ProofWithPublicInputsTarget,
                               proof_with_pis: ProofWithPublicInputs) -> None:
    """Walk the target structure, calling set_target(target, int_value) —
    used for witness filling and for baking dummy proofs in as constants."""

    class _PW:
        @staticmethod
        def set_target(t, v):
            set_target(t, v)

    pw = _PW()
    proof = proof_with_pis.proof
    for t, v in zip(pt.public_inputs, proof_with_pis.public_inputs):
        pw.set_target(t, int(v))

    _set_cap(pw, pt.proof.wires_cap, proof.wires_cap)
    _set_cap(pw, pt.proof.plonk_zs_partial_products_cap,
             proof.plonk_zs_partial_products_cap)
    _set_cap(pw, pt.proof.quotient_polys_cap, proof.quotient_polys_cap)

    ot, ov = pt.proof.openings, proof.openings
    for ts, vs in [(ot.constants, ov.constants), (ot.plonk_sigmas, ov.plonk_sigmas),
                   (ot.wires, ov.wires), (ot.plonk_zs, ov.plonk_zs),
                   (ot.plonk_zs_next, ov.plonk_zs_next),
                   (ot.partial_products, ov.partial_products),
                   (ot.quotient_polys, ov.quotient_polys),
                   (ot.lookup_zs, ov.lookup_zs),
                   (ot.lookup_zs_next, ov.lookup_zs_next)]:
        assert len(ts) == len(vs)
        for t, v in zip(ts, vs):
            _set_ext(pw, t, v)

    ft, fv = pt.proof.opening_proof, proof.opening_proof
    pw.set_target(ft.pow_witness, int(fv.pow_witness))
    for t, v in zip(ft.final_poly, fv.final_poly):
        _set_ext(pw, t, v)
    for cap_t, cap_v in zip(ft.commit_phase_merkle_caps, fv.commit_phase_merkle_caps):
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
