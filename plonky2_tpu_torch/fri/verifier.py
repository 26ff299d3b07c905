"""FRI verifier (host numpy) — twin of reference fri/verifier.rs:21-260 and
fri/challenges.rs:15-66."""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..field import gl64, gl64ext
from ..field.polynomial import barycentric_weights_np, interpolate_ext_np, eval_poly_ext_np
from ..hash.keccak_tree import verify_bytes_merkle_proofs_to_cap
from ..hash.merkle import verify_merkle_proofs_to_cap
from ..iop.challenger import Challenger
from ..utils.bits import log2_strict, reverse_bits, reverse_index_bits
from .config import FriConfig, FriParams
from .proof import FriChallenges, FriProof
from .structure import FriInstanceInfo, FriOpenings


def _verify_to_cap(leaves, indices, cap, siblings) -> bool:
    """Dispatch on the digest type: Poseidon 4-felt caps or keccak byte
    caps."""
    if np.asarray(cap.data).dtype == np.uint8:
        return verify_bytes_merkle_proofs_to_cap(leaves, indices, cap,
                                                 siblings)
    return verify_merkle_proofs_to_cap(leaves, indices, cap, siblings)


def fri_challenges(challenger: Challenger, commit_phase_merkle_caps, final_poly,
                   pow_witness, degree_bits: int, config: FriConfig) -> FriChallenges:
    """Replays the transcript to recover challenges (fri/challenges.rs:24).
    Assumes openings were already observed by the caller."""
    lde_size = 1 << (degree_bits + config.rate_bits)
    fri_alpha = challenger.get_extension_challenge()
    betas = []
    for cap in commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    for c in final_poly:
        challenger.observe_extension_element(c)
    challenger.observe_element(pow_witness)
    fri_pow_response = challenger.get_challenge()
    indices = [int(challenger.get_challenge()) % lde_size
               for _ in range(config.num_query_rounds)]
    return FriChallenges(
        fri_alpha=fri_alpha,
        fri_betas=np.array(betas, dtype=np.uint64).reshape(-1, 2),
        fri_pow_response=fri_pow_response,
        fri_query_indices=indices,
    )


@lru_cache(maxsize=16)
def _alpha_powers(alpha0: int, alpha1: int, k: int) -> np.ndarray:
    """[1, alpha, ..., alpha^(k-1)] (k, 2), shared by every query round."""
    return gl64ext.powers(np.array([alpha0, alpha1], np.uint64), k)


def _reduce_with_alpha(values: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """sum_j alpha^j values[j] for ext values (k, 2), or base values (k,):
    the reference's Horner reduction (ReducingFactor), as one vectorised
    product with the alpha powers and a sum."""
    values = np.asarray(values, dtype=np.uint64)
    powers = _alpha_powers(int(alpha[0]), int(alpha[1]), values.shape[0])
    if values.ndim == 1:
        return gl64ext.total(gl64ext.scalar_mul(powers, values))
    return gl64ext.total(gl64ext.mul(values, powers))


def precompute_reduced_openings(openings: FriOpenings, alpha: np.ndarray) -> list:
    return [_reduce_with_alpha(b.values, alpha) for b in openings.batches]


def fri_combine_initial(instance: FriInstanceInfo, proof, alpha: np.ndarray,
                        subgroup_x: np.uint64, reduced_openings: list,
                        params: FriParams) -> np.ndarray:
    """reference fri/verifier.rs:122-161"""
    x = gl64ext.from_base(subgroup_x)
    total = gl64ext.ZERO
    for batch, reduced in zip(instance.batches, reduced_openings):
        evals = np.array([
            proof.unsalted_eval(p.oracle_index, p.polynomial_index,
                                params.hiding and instance.oracles[p.oracle_index].blinding)
            for p in batch.polynomials], dtype=np.uint64)
        reduced_evals = _reduce_with_alpha(evals, alpha)
        numerator = gl64ext.sub(reduced_evals, reduced)
        denominator = gl64ext.sub(x, batch.point)
        # sum = alpha^k * sum + numerator/denominator (ReducingFactor::shift)
        k = len(batch.polynomials)
        total = gl64ext.mul(total, gl64ext.pow_int(alpha, k))
        total = gl64ext.add(total, gl64ext.mul(numerator, gl64ext.inv(denominator)))
    return total


def compute_evaluation(x: np.uint64, x_index_within_coset: int, arity_bits: int,
                       evals: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """P'(x^arity) from the arity-coset evals (reference fri/verifier.rs:21-46)."""
    arity = 1 << arity_bits
    g = np.uint64(gl64.primitive_root_of_unity(arity_bits))
    evals = reverse_index_bits(np.asarray(evals), axis=0)
    rev_idx = reverse_bits(x_index_within_coset, arity_bits)
    coset_start = gl64.mul(np.uint64(x),
                           np.uint64(pow(int(g), arity - rev_idx, gl64.ORDER_INT)))
    xs = gl64.to_canonical(gl64.mul(coset_start, gl64.powers(int(g), arity)))
    weights = barycentric_weights_np(xs)
    return interpolate_ext_np(xs, evals, weights, beta)


def verify_fri_proof(instance: FriInstanceInfo, openings: FriOpenings,
                     challenges: FriChallenges, initial_merkle_caps: list,
                     proof: FriProof, params: FriParams) -> None:
    """Raises AssertionError on any failure (reference fri/verifier.rs:61);
    a structurally malformed proof raises ShapeError first
    (fri/validate_shape.py, reference fri/validate_shape.rs:11)."""
    from .validate_shape import validate_fri_proof_shape
    validate_fri_proof_shape(
        proof, instance, params,
        digest_width=np.asarray(initial_merkle_caps[0].data).shape[-1])
    n = params.lde_size()
    # PoW
    assert int(challenges.fri_pow_response) < (1 << (64 - params.config.proof_of_work_bits)), \
        "Invalid proof of work witness"

    _verify_merkle_openings(challenges, initial_merkle_caps, proof, params)
    reduced = precompute_reduced_openings(openings, challenges.fri_alpha)
    for x_index, round_proof in zip(challenges.fri_query_indices,
                                    proof.query_round_proofs):
        _verify_query_round(instance, challenges, reduced, proof, x_index, n,
                            round_proof, params)


def _verify_merkle_openings(challenges: FriChallenges, initial_merkle_caps: list,
                            proof: FriProof, params: FriParams) -> None:
    """Every Merkle path of every query round, one batch per tree: the
    initial trees at the query indices, then each commit-phase tree at the
    coset indices (reference fri/verifier.rs:163-260, per-query there)."""
    rounds = proof.query_round_proofs
    x_index = np.asarray(challenges.fri_query_indices, dtype=np.int64)
    for t, cap in enumerate(initial_merkle_caps):
        leaves = np.stack([r.initial_trees_proof.evals_proofs[t][0] for r in rounds])
        sibs = np.stack([r.initial_trees_proof.evals_proofs[t][1].siblings
                         for r in rounds])
        assert _verify_to_cap(leaves, x_index, cap, sibs), \
            "initial Merkle proof failed"
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        x_index = x_index >> arity_bits
        leaves = np.stack([r.steps[i].evals.reshape(-1) for r in rounds])
        sibs = np.stack([r.steps[i].merkle_proof.siblings for r in rounds])
        assert _verify_to_cap(
            leaves, x_index, proof.commit_phase_merkle_caps[i], sibs), \
            f"commit-phase Merkle proof failed at round {i}"


def _verify_query_round(instance, challenges, reduced_openings, proof: FriProof,
                        x_index: int, n: int, round_proof, params):
    log_n = log2_strict(n)
    subgroup_x = gl64.mul(
        np.uint64(gl64.MULTIPLICATIVE_GROUP_GENERATOR),
        np.uint64(pow(gl64.primitive_root_of_unity(log_n),
                      reverse_bits(x_index, log_n), gl64.ORDER_INT)))
    old_eval = fri_combine_initial(instance, round_proof.initial_trees_proof,
                                   challenges.fri_alpha, subgroup_x,
                                   reduced_openings, params)

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = round_proof.steps[i].evals
        coset_index = x_index >> arity_bits
        x_index_within_coset = x_index & (arity - 1)
        assert gl64ext.equal(evals[x_index_within_coset], old_eval), \
            f"consistency check failed at round {i}"
        old_eval = compute_evaluation(subgroup_x, x_index_within_coset,
                                      arity_bits, evals, challenges.fri_betas[i])
        subgroup_x = np.uint64(gl64.exp_power_of_2(int(subgroup_x), arity_bits))
        x_index = coset_index

    final_eval = eval_poly_ext_np(proof.final_poly, gl64ext.from_base(subgroup_x))
    assert gl64ext.equal(final_eval, old_eval), "final polynomial evaluation invalid"
