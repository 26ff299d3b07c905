"""STARK prover (twin of reference starky/src/prover.rs:32-318).

Same pipeline as the reference; the constraint evaluation runs once over the
whole quotient coset as batched torch work instead of packed-SIMD point
batches.  ``prove`` runs on the CUDA device unless the caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl64, ntt
from ..field.extension import GF2
from ..field.goldilocks import GF, batch_inv
from ..field.polynomial import eval_polys_at_ext, powers_ext
from ..fri.oracle import COSET_SHIFT, PolynomialBatch
from ..iop.challenger import Challenger, permutation_for
from ..plonk.gates.base import BaseBatchCtx
from ..plonk.prover import _z_h_on_coset
from ..utils.bits import log2_strict
from ..utils.cuda import resolve_device
from ..utils.timing import TimingTree
from .config import StarkConfig
from .permutation import (compute_permutation_z_polys_gf,
                          eval_permutation_checks,
                          get_n_permutation_challenge_sets)
from .proof import StarkOpeningSet, StarkProof, StarkProofWithPublicInputs
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

P = gl64.ORDER_INT


def prove(stark: Stark, config: StarkConfig, trace_poly_values: GF,
          public_inputs: np.ndarray, timing: TimingTree | None = None,
          device=None, trace_commitment=None,
          mesh=None) -> StarkProofWithPublicInputs:
    """trace_poly_values: (COLUMNS, degree) evaluations over the subgroup.
    device: where the prove runs; None means CUDA.

    trace_commitment: optionally a precomputed PolynomialBatch of the
    trace on that device (e.g. from a pipelined device group,
    parallel/groups.py); it must equal ``from_values(trace_poly_values,
    ...)``.

    mesh: a parallel.mesh.Mesh runs the whole pipeline distributed over
    its ranks (parallel/stark_prover.py), on the rank's mesh.device, and
    returns a byte-identical proof; every rank calls prove with the same
    arguments.
    """
    if mesh is not None:
        if trace_commitment is not None:
            raise ValueError("precomputed commitments are single-device")
        from ..parallel.stark_prover import prove_sharded
        return prove_sharded(stark, config, trace_poly_values, public_inputs,
                             mesh, timing)
    device = resolve_device(device)
    permutation = permutation_for(config.hasher)
    trace_poly_values = GF(trace_poly_values.v.to(device))
    degree = trace_poly_values.shape[-1]
    degree_bits = log2_strict(degree)
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    if fri_params.total_arities() > degree_bits + rate_bits - cap_height:
        raise ValueError("FRI arities exceed the LDE height above the cap")
    if timing is None:
        timing = TimingTree("prove", device)

    if trace_commitment is None:
        with timing.scope("trace commitment (LDE + Merkle)"):
            trace_commitment = PolynomialBatch.from_values(
                trace_poly_values, rate_bits, False, cap_height,
                config.hasher)
    challenger = Challenger(permutation)
    challenger.observe_cap(trace_commitment.merkle_tree.cap)

    # permutation arguments (starky/src/prover.rs:75-112)
    perm_zs_commitment = None
    challenge_sets = None
    if stark.uses_permutation_args():
        challenge_sets = get_n_permutation_challenge_sets(
            challenger, config.num_challenges, stark.permutation_batch_size())
        with timing.scope("permutation Z polys"):
            z_polys = compute_permutation_z_polys_gf(
                stark, config, trace_poly_values, challenge_sets)
        with timing.scope("permutation Z commitment"):
            perm_zs_commitment = PolynomialBatch.from_values(
                z_polys, rate_bits, False, cap_height, config.hasher)
        challenger.observe_cap(perm_zs_commitment.merkle_tree.cap)

    alphas = challenger.get_n_challenges(config.num_challenges)

    with timing.scope("quotient values + coefficients"):
        quotient_chunks = _compute_quotient_polys(
            stark, trace_commitment, public_inputs, alphas, degree_bits,
            config, perm_zs_commitment, challenge_sets)
    with timing.scope("quotient commitment"):
        quotient_commitment = PolynomialBatch.from_coeffs(
            quotient_chunks, rate_bits, False, cap_height, config.hasher)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    zeta_np = challenger.get_extension_challenge()
    g = gl64.primitive_root_of_unity(degree_bits)
    zeta = GF2.from_u64_pair(zeta_np[0], zeta_np[1], device)
    zeta_g = zeta * g
    with timing.scope("openings at zeta / g*zeta"):
        zpow = powers_ext(zeta, degree)
        zgpow = powers_ext(zeta_g, degree)

        def at(batch, pw):
            return eval_polys_at_ext(batch.polynomials, pw).to_u64()

        openings = StarkOpeningSet(
            local_values=at(trace_commitment, zpow),
            next_values=at(trace_commitment, zgpow),
            quotient_polys=at(quotient_commitment, zpow),
            permutation_zs=at(perm_zs_commitment, zpow)
            if perm_zs_commitment else None,
            permutation_zs_next=at(perm_zs_commitment, zgpow)
            if perm_zs_commitment else None,
        )
    for batch in openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)

    commitments = [trace_commitment]
    if perm_zs_commitment is not None:
        commitments.append(perm_zs_commitment)
    commitments.append(quotient_commitment)
    with timing.scope("FRI opening proof"):
        opening_proof = PolynomialBatch.prove_openings(
            stark.fri_instance(zeta_np, g, config), commitments,
            challenger, fri_params, timing)

    proof = StarkProof(
        trace_cap=trace_commitment.merkle_tree.cap,
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings,
        opening_proof=opening_proof,
        permutation_zs_cap=perm_zs_commitment.merkle_tree.cap
        if perm_zs_commitment else None,
    )
    return StarkProofWithPublicInputs(proof, np.asarray(public_inputs, np.uint64))


def _compute_quotient_polys(stark: Stark, trace_commitment, public_inputs,
                            alphas, degree_bits: int, config,
                            perm_zs_commitment=None, challenge_sets=None) -> GF:
    """Constraints over the whole quotient coset at once, divided by Z_H,
    then a coset iNTT and the qdf trim of the chunks."""
    device = trace_commitment.polynomials.device
    degree = 1 << degree_bits
    rate_bits = config.fri_config.rate_bits
    qdb = (stark.quotient_degree_factor() - 1).bit_length()
    if qdb > rate_bits:
        raise ValueError("quotient degree exceeds the blowup")
    step = 1 << (rate_bits - qdb)
    next_step = 1 << qdb

    trace = GF(trace_commitment.lde_values_natural().v[:, ::step])
    trace_next = GF(torch.roll(trace.v, -next_step, dims=-1))

    big = gl64.two_adic_subgroup(degree_bits + qdb)
    xs = GF.from_u64(gl64.mul(big, np.uint64(COSET_SHIFT)), device)
    last = pow(gl64.primitive_root_of_unity(degree_bits), P - 2, P)
    z_last = xs - last

    # L_0 = Z_H/(n(x-1)), L_{n-1} = Z_H/(n(x-g^{n-1}))
    zh = _z_h_on_coset(degree_bits, qdb)
    zh_tiled = GF.from_u64(np.tile(zh, degree), device)
    lag_first = zh_tiled * batch_inv((xs - 1) * degree)
    lag_last = zh_tiled * batch_inv((xs - last) * degree)

    ctx = BaseBatchCtx(device)
    vars = StarkEvaluationVars(
        local_values=[trace[i] for i in range(stark.COLUMNS)],
        next_values=[trace_next[i] for i in range(stark.COLUMNS)],
        public_inputs=[ctx.constant(int(pi)) for pi in public_inputs],
    )
    consumer = ConstraintConsumer(ctx, [int(a) for a in alphas], z_last,
                                  lag_first, lag_last)
    stark.eval_generic(ctx, vars, consumer)
    if perm_zs_commitment is not None:
        perm = GF(perm_zs_commitment.lde_values_natural().v[:, ::step])
        perm_next = GF(torch.roll(perm.v, -next_step, dims=-1))
        eval_permutation_checks(
            ctx, stark, config, vars,
            [perm[i] for i in range(perm.shape[0])],
            [perm_next[i] for i in range(perm_next.shape[0])],
            challenge_sets, consumer)

    zh_inv_tiled = GF.from_u64(np.tile(gl64.batch_inv(zh), degree), device)
    quotient_values = GF.stack(
        [acc * zh_inv_tiled for acc in consumer.accumulators()], axis=0)
    quotient_coeffs = ntt.coset_intt(quotient_values, COSET_SHIFT)
    # keep qdf chunks of each challenge's quotient (the rest are zero)
    qdf = stark.quotient_degree_factor()
    chunks = quotient_coeffs.reshape(config.num_challenges, 1 << qdb, degree)
    return chunks[:, :qdf, :].reshape(config.num_challenges * qdf, degree)
