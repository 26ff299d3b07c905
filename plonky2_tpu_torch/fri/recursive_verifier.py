"""In-circuit FRI verifier (twin of reference fri/recursive_verifier.rs:101-481).

Targets mirror the host `FriProof` layout one-to-one, so witness filling is a
structural walk.  Query indices are challenge targets decomposed into bits;
Merkle paths are walked with swap-bit Poseidon rows; coset interpolation goes
through CosetInterpolationGate; alpha/beta folds through Reducing gates.
Host only, as in the JAX package: it adds gates to a builder and never
touches a device.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl64
from ..plonk.gadgets import ReducingFactorTarget
from ..plonk.gates.interpolation import CosetInterpolationGate
from ..plonk import targets as tg
from ..utils.bits import log2_strict, reverse_index_bits_list
from .config import FriParams

COSET_SHIFT = gl64.MULTIPLICATIVE_GROUP_GENERATOR


# -- target containers (twins of fri/proof.rs *Target structs) ---------------

@dataclass
class MerkleProofTarget:
    siblings: list  # of [4 targets]


@dataclass
class FriInitialTreeProofTarget:
    evals_proofs: list  # of (list[Target], MerkleProofTarget)

    def unsalted_eval(self, oracle_index, poly_index, salted):
        return self.evals_proofs[oracle_index][0][poly_index]


@dataclass
class FriQueryStepTarget:
    evals: list  # of ext targets
    merkle_proof: MerkleProofTarget


@dataclass
class FriQueryRoundTarget:
    initial_trees_proof: FriInitialTreeProofTarget
    steps: list


@dataclass
class FriProofTarget:
    commit_phase_merkle_caps: list  # of caps (list of [4 targets])
    query_round_proofs: list
    final_poly: list  # of ext targets
    pow_witness: int


@dataclass
class FriChallengesTarget:
    fri_alpha: tuple
    fri_betas: list  # of ext targets
    fri_pow_response: int
    fri_query_indices: list  # of targets


# -- virtual-target allocation (fri/recursive_verifier.rs:383-460) -----------

def add_virtual_cap(b, cap_height: int) -> list:
    return [b.add_virtual_targets(4) for _ in range(1 << cap_height)]


def add_virtual_merkle_proof(b, length: int) -> MerkleProofTarget:
    return MerkleProofTarget([b.add_virtual_targets(4) for _ in range(length)])


def add_virtual_fri_proof(b, num_leaves_per_oracle: list,
                          params: FriParams) -> FriProofTarget:
    cap_height = params.config.cap_height
    caps = [add_virtual_cap(b, cap_height)
            for _ in params.reduction_arity_bits]
    rounds = [_add_virtual_fri_query(b, num_leaves_per_oracle, params)
              for _ in range(params.config.num_query_rounds)]
    final_poly = b.add_virtual_extension_targets(params.final_poly_len())
    pow_witness = b.add_virtual_target()
    return FriProofTarget(caps, rounds, final_poly, pow_witness)


def _add_virtual_fri_query(b, num_leaves_per_oracle, params) -> FriQueryRoundTarget:
    merkle_proof_len = params.lde_bits() - params.config.cap_height
    evals_proofs = [
        (b.add_virtual_targets(n), add_virtual_merkle_proof(b, merkle_proof_len))
        for n in num_leaves_per_oracle
    ]
    steps = []
    for arity_bits in params.reduction_arity_bits:
        merkle_proof_len -= arity_bits
        steps.append(FriQueryStepTarget(
            evals=b.add_virtual_extension_targets(1 << arity_bits),
            merkle_proof=add_virtual_merkle_proof(b, merkle_proof_len)))
    return FriQueryRoundTarget(FriInitialTreeProofTarget(evals_proofs), steps)


# -- verification -------------------------------------------------------------

def interpolate_coset(b, gate: CosetInterpolationGate, coset_shift: int,
                      values: list, evaluation_point: tuple) -> tuple:
    """Add one CosetInterpolationGate row; returns the interpolated value."""
    row = b.add_gate(gate, [])
    b.connect(coset_shift, tg.wire(row, gate.wire_shift()))
    for i, v in enumerate(values):
        w = gate.wires_value(i)
        b.connect_extension(v, (tg.wire(row, w), tg.wire(row, w + 1)))
    w = gate.wires_evaluation_point()
    b.connect_extension(evaluation_point, (tg.wire(row, w), tg.wire(row, w + 1)))
    w = gate.wires_evaluation_value()
    return (tg.wire(row, w), tg.wire(row, w + 1))


def compute_evaluation(b, x: int, x_index_within_coset_bits: list,
                       arity_bits: int, evals: list, beta: tuple) -> tuple:
    """P'(x^arity) from the arity-coset evals (fri/recursive_verifier.rs:27)."""
    arity = 1 << arity_bits
    assert len(evals) == arity
    g = gl64.primitive_root_of_unity(arity_bits)
    g_inv = gl64.pow_scalar(g, arity - 1)

    # reorder (host-side permutation of the target list) into natural order
    evals = reverse_index_bits_list(list(evals))
    # coset_start = x * g^(arity - rev_idx) = x * g_inv^rev_idx;
    # rev_idx's little-endian bits are the reversed index bits
    start = b.exp_from_bits_const_base(g_inv, list(reversed(x_index_within_coset_bits)))
    coset_start = b.mul(start, x)

    gate = CosetInterpolationGate(arity_bits, b.config.max_quotient_degree_factor)
    return interpolate_coset(b, gate, coset_start, evals, beta)


def fri_combine_initial(b, instance, proof: FriInitialTreeProofTarget,
                        alpha: tuple, subgroup_x: int,
                        reduced_openings: list, params: FriParams) -> tuple:
    """reference fri/recursive_verifier.rs:205-252."""
    subgroup_x_ext = b.convert_to_ext(subgroup_x)
    alpha_f = ReducingFactorTarget(alpha)
    total = b.zero_extension()
    for batch, reduced in zip(instance.batches, reduced_openings):
        evals = [proof.unsalted_eval(p.oracle_index, p.polynomial_index,
                                     params.hiding and instance.oracles[p.oracle_index].blinding)
                 for p in batch.polynomials]
        reduced_evals = alpha_f.reduce_base(evals, b)
        numerator = b.sub_extension(reduced_evals, reduced)
        denominator = b.sub_extension(subgroup_x_ext, batch.point)
        total = alpha_f.shift(total, b)
        total = b.add_extension(total, b.div_extension(numerator, denominator))
    return total


def verify_fri_proof_circuit(b, instance, openings, challenges: FriChallengesTarget,
                             initial_merkle_caps: list, proof: FriProofTarget,
                             params: FriParams) -> None:
    assert params.final_poly_len() == len(proof.final_poly)
    n = params.lde_size()

    # PoW: response must have proof_of_work_bits leading zeros
    b.assert_leading_zeros(challenges.fri_pow_response,
                           params.config.proof_of_work_bits)
    assert params.config.num_query_rounds == len(proof.query_round_proofs)

    # precompute reduced openings per batch
    reduced = [ReducingFactorTarget(challenges.fri_alpha).reduce(batch.values, b)
               for batch in openings.batches]

    for x_index, round_proof in zip(challenges.fri_query_indices,
                                    proof.query_round_proofs):
        _query_round(b, instance, challenges, reduced, initial_merkle_caps,
                     proof, x_index, n, round_proof, params)


def _query_round(b, instance, challenges, reduced_openings, initial_merkle_caps,
                 proof, x_index, n, round_proof, params):
    n_log = log2_strict(n)
    # Non-canonical decompositions are sound here for Goldilocks
    # (fri/recursive_verifier.rs:352 analysis).
    x_index_bits = b.low_bits(x_index, n_log, 64)
    cap_index = b.le_sum(x_index_bits[len(x_index_bits) - params.config.cap_height:])

    for (evals, merkle_proof), cap in zip(
            round_proof.initial_trees_proof.evals_proofs, initial_merkle_caps):
        b.verify_merkle_proof_to_cap_with_cap_index(
            evals, x_index_bits, cap_index, cap, merkle_proof.siblings)

    # subgroup_x = shift * phi^x_index (bit-reversed exponent)
    phi = gl64.primitive_root_of_unity(n_log)
    phi_pow = b.exp_from_bits_const_base(phi, list(reversed(x_index_bits)))
    subgroup_x = b.mul_const(COSET_SHIFT, phi_pow)

    old_eval = fri_combine_initial(b, instance, round_proof.initial_trees_proof,
                                   challenges.fri_alpha, subgroup_x,
                                   reduced_openings, params)

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        evals = round_proof.steps[i].evals
        coset_index_bits = x_index_bits[arity_bits:]
        within_bits = x_index_bits[:arity_bits]
        within = b.le_sum(within_bits)

        new_eval = b.random_access_extension(within, evals)
        b.connect_extension(new_eval, old_eval)

        old_eval = compute_evaluation(b, subgroup_x, within_bits, arity_bits,
                                      evals, challenges.fri_betas[i])

        flat = [c for e in evals for c in e]
        b.verify_merkle_proof_to_cap_with_cap_index(
            flat, coset_index_bits, cap_index,
            proof.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof.siblings)

        subgroup_x = b.exp_power_of_2(subgroup_x, arity_bits)
        x_index_bits = coset_index_bits

    # final polynomial evaluation at subgroup_x (Horner over ext coeffs)
    x_ext = b.convert_to_ext(subgroup_x)
    acc = b.zero_extension()
    for c in reversed(proof.final_poly):
        acc = b.mul_add_extension(acc, x_ext, c)
    b.connect_extension(acc, old_eval)
