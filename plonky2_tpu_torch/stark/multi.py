"""Multi-table STARK proving with cross-table lookups.

Twin of the reference zkEVM proving machinery (evm/src/prover.rs:94-467,
evm/src/verifier.rs:29-216, evm/src/proof.rs:207-293, evm/src/stark.rs:83),
generic over any list of Starks + CrossTableLookups rather than hard-coded
to the EVM tables.

One Fiat-Shamir challenger threads through the whole proof: all trace caps
are observed first, then the CTL (beta, gamma) challenges are drawn, then
each table is proven in order, its permutation+CTL Z commitment, quotient,
opening and FRI phases continuing the same transcript
(evm/src/get_challenges.rs:18-49).

``prove_multi_table`` runs on one device (CUDA unless the caller names
another): trace, Z and quotient commitments, the permutation and CTL Z
columns, the quotient pass and the openings are torch work there.  The
CTL Z columns are the reference's host computation
(ctl.cross_table_lookup_data) done on the device, as the permutation Zs
are (permutation.compute_permutation_z_polys_gf): the same field values,
without hundreds of host numpy passes over up to 2^21 rows.
Verification is host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import gl64, gl64ext, ntt
from ..field.extension import GF2
from ..field.gl64ext import E2
from ..field.goldilocks import GF, batch_inv, exclusive_scan, mul
from ..field.polynomial import eval_polys_at_ext, powers_ext
from ..fri.oracle import COSET_SHIFT, PolynomialBatch
from ..fri.proof import FriProof
from ..fri.structure import (FriBatchInfo, FriInstanceInfo, FriOpeningBatch,
                             FriOpenings, FriOracleInfo, FriPolynomialInfo)
from ..fri.verifier import fri_challenges, verify_fri_proof
from ..iop.challenger import Challenger, permutation_for
from ..plonk.gates.base import BaseBatchCtx, ExtCtx
from ..plonk.prover import _z_h_on_coset
from ..utils.bits import log2_strict
from ..utils.cuda import resolve_device
from ..utils.timing import TimingTree
from .config import StarkConfig
from .ctl import (CtlCheckVars, CtlData, CtlZData, ctl_check_vars_per_table,
                  eval_cross_table_lookup_checks,
                  get_grand_product_challenge_set, num_ctl_zs,
                  verify_cross_table_lookups)
from .permutation import (compute_permutation_z_polys_gf,
                          eval_permutation_checks,
                          get_n_permutation_challenge_sets)
from .proof import StarkProofChallenges
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

P = gl64.ORDER_INT


@dataclass
class MultiStarkOpeningSet:
    """Per-table openings (evm/src/proof.rs:209): permutation and CTL Z
    polys share one oracle; CTL Zs additionally open at g^{n-1} (base
    field) so the verifier can multiply final products across tables."""

    local_values: np.ndarray        # (COLUMNS, 2) at zeta
    next_values: np.ndarray         # (COLUMNS, 2) at g*zeta
    permutation_ctl_zs: np.ndarray  # (num_perm+num_ctl, 2) at zeta
    permutation_ctl_zs_next: np.ndarray
    ctl_zs_last: np.ndarray         # (num_ctl,) base felts at g^{n-1}
    quotient_polys: np.ndarray      # (num_quotient, 2) at zeta

    def to_fri_openings(self) -> FriOpenings:
        """(proof.rs:261): zeta batch, g*zeta batch, then the g^{n-1} batch
        holding only the CTL Zs (embedded into the extension)."""
        last_ext = np.zeros((len(self.ctl_zs_last), 2), np.uint64)
        last_ext[:, 0] = self.ctl_zs_last
        return FriOpenings(batches=[
            FriOpeningBatch(values=np.concatenate(
                [self.local_values, self.permutation_ctl_zs,
                 self.quotient_polys])),
            FriOpeningBatch(values=np.concatenate(
                [self.next_values, self.permutation_ctl_zs_next])),
            FriOpeningBatch(values=last_ext),
        ])


@dataclass
class MultiTableStarkProof:
    """(evm/src/proof.rs:87 StarkProof + StarkProofWithMetadata: the
    challenger state at the start of this table's transcript phases,
    recorded so per-table wrapper circuits can be proven independently
    and chained by state equality, evm/src/prover.rs compact())."""

    trace_cap: object
    permutation_ctl_zs_cap: object
    quotient_polys_cap: object
    openings: MultiStarkOpeningSet
    opening_proof: FriProof
    degree_bits: int
    init_challenger_state: np.ndarray = None


@dataclass
class MultiProof:
    """(evm/src/proof.rs:24 AllProof): one proof per table; the CTL
    challenges are re-derived by the verifier from the trace caps."""

    stark_proofs: list

    def degree_bits(self) -> list:
        return [p.degree_bits for p in self.stark_proofs]


def fri_instance_ctl(stark: Stark, zeta: np.ndarray, g: int,
                     degree_bits: int, num_perm_zs: int, num_ctl: int,
                     config: StarkConfig) -> FriInstanceInfo:
    """(evm/src/stark.rs:83) oracles: trace | perm+ctl Zs | quotient;
    batches: zeta, g*zeta, g^{n-1} (CTL Zs only)."""
    num_zs = num_perm_zs + num_ctl
    oracles = [FriOracleInfo(stark.COLUMNS, False),
               FriOracleInfo(num_zs, False),
               FriOracleInfo(stark.num_quotient_polys(config), False)]
    trace_info = FriPolynomialInfo.from_range(0, 0, stark.COLUMNS)
    zs_info = FriPolynomialInfo.from_range(1, 0, num_zs)
    ctl_info = FriPolynomialInfo.from_range(1, num_perm_zs, num_zs)
    quotient_info = FriPolynomialInfo.from_range(
        2, 0, stark.num_quotient_polys(config))
    zeta = np.asarray(zeta, np.uint64)
    zeta_next = gl64ext.scalar_mul(zeta, np.uint64(g))
    last = pow(g, P - 2, P)  # g^{n-1} = g^{-1}
    last_ext = np.array([last, 0], np.uint64)
    return FriInstanceInfo(
        oracles=oracles,
        batches=[
            FriBatchInfo(point=zeta,
                         polynomials=trace_info + zs_info + quotient_info),
            FriBatchInfo(point=zeta_next, polynomials=trace_info + zs_info),
            FriBatchInfo(point=last_ext, polynomials=ctl_info),
        ],
    )


def _ctl_columns(ctx, trace: list, twc) -> tuple:
    """The looked-up columns and the filter of one CTL occurrence over a
    table's rows (cross_table_lookup.rs:279): (terms, filter or None)."""
    n = trace[0].shape[-1]
    terms = [c.eval(ctx, trace).broadcast_to((n,)) for c in twc.columns]
    if twc.filter_column is None:
        return terms, None
    filt = twc.filter_column.eval(ctx, trace).broadcast_to((n,))
    canon = filt.canonical().v
    if not bool(((canon == 0) | (canon == 1)).all()):
        raise ValueError("non-binary CTL filter")
    return terms, filt


def _ctl_z_column(ctx, terms: list, filt, challenge) -> GF:
    """One CTL Z column (the twin of ctl._partial_products): the inclusive
    running product of combine(row) over filtered rows, factor 1 on the
    others."""
    combined = challenge.combine(ctx, terms)
    if filt is not None:
        combined = filt * combined + 1 - filt
    return GF(mul(exclusive_scan(combined.v), combined.v))


def cross_table_lookup_data_gf(traces: list, ctls: list,
                               ctl_challenges: list) -> list:
    """Every table's CTL Z columns (cross_table_lookup.rs:220) from the
    device traces (per table a GF (COLUMNS, n)), in the reference's order:
    for each CTL, for each challenge, looking occurrences then the looked
    one.  Each CtlZData.z is a device GF (n,).  Raises ValueError if the
    looking and looked multisets differ."""
    ctx = BaseBatchCtx(traces[0].device)
    rows = [[t[i] for i in range(t.shape[0])] for t in traces]
    data = [CtlData() for _ in traces]
    for ctl in ctls:
        occurrences = [*ctl.looking_tables, ctl.looked_table]
        columns = [_ctl_columns(ctx, rows[t.table], t) for t in occurrences]
        for challenge in ctl_challenges:
            zs = [_ctl_z_column(ctx, terms, filt, challenge)
                  for terms, filt in columns]
            prod = zs[0][-1:]
            for z in zs[1:-1]:
                prod = prod * z[-1:]
            if not np.array_equal(prod.to_u64(), zs[-1][-1:].to_u64()):
                raise ValueError(
                    "CTL multisets do not match (inconsistent traces)")
            for twc, z in zip(occurrences, zs):
                data[twc.table].zs_columns.append(
                    CtlZData(z, challenge, twc.columns, twc.filter_column))
    return data


def prove_multi_table(starks: list, ctls: list, config: StarkConfig,
                      trace_poly_values: list, public_inputs: list = None,
                      timing: TimingTree | None = None,
                      device=None, mesh_groups: list = None) -> MultiProof:
    """(evm/src/prover.rs:94 prove_with_traces) trace_poly_values: per
    table an (COLUMNS, n) u64 array of subgroup evaluations.  device:
    where the prove runs; None means CUDA.

    mesh_groups: optionally a list of rank groups
    (parallel.groups.device_groups); the trace commitments then run on
    them, table t on group t % len(groups), concurrently, and are handed
    to every rank, which proves the rest on its mesh device, bit-identical
    to the single-device path.  Every rank calls this with the same
    arguments."""
    if mesh_groups:
        device = mesh_groups[0].device
    device = resolve_device(device)
    if timing is None:
        timing = TimingTree("prove", device)
    num_tables = len(starks)
    if public_inputs is None:
        public_inputs = [np.zeros(0, np.uint64)] * num_tables
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height

    traces = [GF.from_u64(t, device) for t in trace_poly_values]
    with timing.scope("compute all trace commitments"):
        if mesh_groups:
            if config.hasher != "poseidon":
                raise ValueError("the device groups commit with Poseidon")
            from ..parallel.groups import grouped_trace_commitments
            trace_commitments = grouped_trace_commitments(
                traces, rate_bits, cap_height, mesh_groups)
        else:
            trace_commitments = [
                PolynomialBatch.from_values(t, rate_bits, False, cap_height,
                                            config.hasher)
                for t in traces]

    challenger = Challenger(permutation_for(config.hasher))
    for c in trace_commitments:
        challenger.observe_cap(c.merkle_tree.cap)

    ctl_challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges)
    with timing.scope("compute CTL data"):
        ctl_data_per_table = cross_table_lookup_data_gf(
            traces, ctls, ctl_challenges)

    stark_proofs = []
    for i, stark in enumerate(starks):
        # boundary compact: makes the shared transcript identical whether
        # tables are verified monolithically or by independent wrapper
        # circuits seeded from this state (evm/src/prover.rs:262)
        init_state = challenger.compact()
        with timing.scope(f"prove table {i} ({type(stark).__name__})"):
            p = prove_single_table(
                stark, config, traces[i], trace_commitments[i],
                ctl_data_per_table[i], public_inputs[i], challenger, timing)
        p.init_challenger_state = init_state
        stark_proofs.append(p)
    return MultiProof(stark_proofs)


def prove_single_table(stark: Stark, config: StarkConfig, trace: GF,
                       trace_commitment, ctl_data, public_inputs: np.ndarray,
                       challenger: Challenger,
                       timing: TimingTree) -> MultiTableStarkProof:
    """(evm/src/prover.rs:288): continues the shared challenger, on the
    device that holds the trace (COLUMNS, n) and its commitment."""
    device = trace.device
    degree = trace.shape[-1]
    degree_bits = log2_strict(degree)
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    if fri_params.total_arities() > degree_bits + rate_bits - cap_height:
        raise ValueError("FRI arities exceed the LDE height above the cap")
    if len(ctl_data) == 0:
        raise ValueError(f"no CTL Zs for table {type(stark).__name__}")

    # permutation challenges + Z polys, then CTL Zs share the commitment
    challenge_sets = None
    num_perm_zs = 0
    with timing.scope("permutation + CTL Z commitment"):
        z_parts = []
        if stark.uses_permutation_args():
            challenge_sets = get_n_permutation_challenge_sets(
                challenger, config.num_challenges,
                stark.permutation_batch_size())
            perm_zs = compute_permutation_z_polys_gf(
                stark, config, trace, challenge_sets)
            num_perm_zs = perm_zs.shape[0]
            z_parts.append(perm_zs)
        z_parts.append(GF.stack([zc.z for zc in ctl_data.zs_columns]))
        zs_commitment = PolynomialBatch.from_values(
            GF.concatenate(z_parts, axis=0), rate_bits, False, cap_height,
            config.hasher)
    challenger.observe_cap(zs_commitment.merkle_tree.cap)

    alphas = challenger.get_n_challenges(config.num_challenges)
    with timing.scope("quotient values + coefficients"):
        quotient_chunks = _compute_quotient_polys_ctl(
            stark, trace_commitment, zs_commitment, public_inputs, alphas,
            degree_bits, config, num_perm_zs, ctl_data, challenge_sets)
    with timing.scope("quotient commitment"):
        quotient_commitment = PolynomialBatch.from_coeffs(
            quotient_chunks, rate_bits, False, cap_height, config.hasher)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    zeta_np = challenger.get_extension_challenge()
    g = gl64.primitive_root_of_unity(degree_bits)
    with timing.scope("openings at zeta / g*zeta / g^(n-1)"):
        zeta = GF2.from_u64_pair(zeta_np[0], zeta_np[1], device)
        zpow = powers_ext(zeta, degree)
        zgpow = powers_ext(zeta * g, degree)
        lastpow = powers_ext(
            GF2.from_u64_pair(np.uint64(pow(g, P - 2, P)), np.uint64(0),
                              device), degree)

        def at(batch, pw):
            return eval_polys_at_ext(batch.polynomials, pw).to_u64()

        openings = MultiStarkOpeningSet(
            local_values=at(trace_commitment, zpow),
            next_values=at(trace_commitment, zgpow),
            permutation_ctl_zs=at(zs_commitment, zpow),
            permutation_ctl_zs_next=at(zs_commitment, zgpow),
            ctl_zs_last=at(zs_commitment, lastpow)[num_perm_zs:, 0].copy(),
            quotient_polys=at(quotient_commitment, zpow),
        )
    for batch in openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)

    with timing.scope("FRI opening proof"):
        opening_proof = PolynomialBatch.prove_openings(
            fri_instance_ctl(stark, zeta_np, g, degree_bits, num_perm_zs,
                             len(ctl_data), config),
            [trace_commitment, zs_commitment, quotient_commitment],
            challenger, fri_params, timing)

    return MultiTableStarkProof(
        trace_cap=trace_commitment.merkle_tree.cap,
        permutation_ctl_zs_cap=zs_commitment.merkle_tree.cap,
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings,
        opening_proof=opening_proof,
        degree_bits=degree_bits,
    )


def _compute_quotient_polys_ctl(stark: Stark, trace_commitment,
                                zs_commitment, public_inputs, alphas,
                                degree_bits: int, config, num_perm_zs: int,
                                ctl_data, challenge_sets) -> GF:
    """Quotient over the whole coset in one batched pass (stark analogue of
    evm/src/prover.rs:471), with permutation + CTL Z checks folded in."""
    device = trace_commitment.polynomials.device
    degree = 1 << degree_bits
    rate_bits = config.fri_config.rate_bits
    qdb = (stark.quotient_degree_factor() - 1).bit_length()
    if qdb > rate_bits:
        raise ValueError("quotient degree exceeds the blowup")
    step = 1 << (rate_bits - qdb)
    next_step = 1 << qdb

    def lde_pair(commitment):
        vals = GF(commitment.lde_values_natural().v[:, ::step])
        return vals, GF(torch.roll(vals.v, -next_step, dims=-1))

    trace, trace_next = lde_pair(trace_commitment)
    zs, zs_next = lde_pair(zs_commitment)

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
    if num_perm_zs:
        eval_permutation_checks(
            ctx, stark, config, vars,
            [zs[i] for i in range(num_perm_zs)],
            [zs_next[i] for i in range(num_perm_zs)],
            challenge_sets, consumer)
    ctl_vars = [
        CtlCheckVars(zs[num_perm_zs + i], zs_next[num_perm_zs + i],
                     zc.challenge, zc.columns, zc.filter_column)
        for i, zc in enumerate(ctl_data.zs_columns)]
    eval_cross_table_lookup_checks(ctx, vars, ctl_vars, consumer)

    zh_inv_tiled = GF.from_u64(np.tile(gl64.batch_inv(zh), degree), device)
    quotient_values = GF.stack(
        [acc * zh_inv_tiled for acc in consumer.accumulators()], axis=0)
    quotient_coeffs = ntt.coset_intt(quotient_values, COSET_SHIFT)
    # keep qdf chunks of each challenge's quotient (the rest are zero)
    qdf = stark.quotient_degree_factor()
    chunks = quotient_coeffs.reshape(config.num_challenges, 1 << qdb, degree)
    return chunks[:, :qdf, :].reshape(config.num_challenges * qdf, degree)


def _get_challenges_multi(starks: list, proof: MultiProof,
                          config: StarkConfig) -> tuple:
    """Replay the shared transcript (evm/src/get_challenges.rs:18)."""
    challenger = Challenger(permutation_for(config.hasher))
    for p in proof.stark_proofs:
        challenger.observe_cap(p.trace_cap)
    ctl_challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges)

    all_challenges = []
    for stark, p in zip(starks, proof.stark_proofs):
        challenger.compact()  # boundary, mirrors the prover
        challenge_sets = None
        if stark.uses_permutation_args():
            challenge_sets = get_n_permutation_challenge_sets(
                challenger, config.num_challenges,
                stark.permutation_batch_size())
        challenger.observe_cap(p.permutation_ctl_zs_cap)
        alphas = challenger.get_n_challenges(config.num_challenges)
        challenger.observe_cap(p.quotient_polys_cap)
        zeta = challenger.get_extension_challenge()
        for batch in p.openings.to_fri_openings().batches:
            for v in batch.values:
                challenger.observe_extension_element(v)
        fri = fri_challenges(
            challenger, p.opening_proof.commit_phase_merkle_caps,
            p.opening_proof.final_poly, p.opening_proof.pow_witness,
            p.degree_bits, config.fri_config)
        all_challenges.append(
            StarkProofChallenges(alphas, zeta, fri, challenge_sets))
    return ctl_challenges, all_challenges


def verify_multi_table(starks: list, ctls: list, proof: MultiProof,
                       config: StarkConfig,
                       public_inputs: list = None) -> None:
    """(evm/src/verifier.rs:29 verify_proof); raises AssertionError on a
    bad proof."""
    num_tables = len(starks)
    if public_inputs is None:
        public_inputs = [np.zeros(0, np.uint64)] * num_tables
    ctl_challenges, all_challenges = _get_challenges_multi(
        starks, proof, config)

    zs_per_table = []
    for i, (stark, p) in enumerate(zip(starks, proof.stark_proofs)):
        num_perm = (stark.num_permutation_batches(config)
                    if stark.uses_permutation_args() else 0)
        expected_ctl = num_ctl_zs(ctls, i, config.num_challenges)
        openings = p.openings
        assert openings.permutation_ctl_zs.shape[0] == num_perm + expected_ctl
        assert openings.ctl_zs_last.shape[0] == expected_ctl
        zs_per_table.append([
            (E2(openings.permutation_ctl_zs[j]),
             E2(openings.permutation_ctl_zs_next[j]))
            for j in range(num_perm, num_perm + expected_ctl)])
    ctl_vars_per_table = ctl_check_vars_per_table(
        ctls, ctl_challenges, num_tables, zs_per_table)

    for i, (stark, p) in enumerate(zip(starks, proof.stark_proofs)):
        _verify_single_table(stark, p, all_challenges[i],
                             ctl_vars_per_table[i], public_inputs[i], config)

    verify_cross_table_lookups(
        ctls, [p.openings.ctl_zs_last for p in proof.stark_proofs],
        config.num_challenges)


def _verify_single_table(stark: Stark, proof: MultiTableStarkProof,
                         challenges: StarkProofChallenges, ctl_vars: list,
                         public_inputs: np.ndarray,
                         config: StarkConfig) -> None:
    """(evm/src/verifier.rs:116 verify_stark_proof_with_challenges)"""
    openings = proof.openings
    degree_bits = proof.degree_bits
    ctx = ExtCtx()
    zeta = E2(challenges.stark_zeta)
    degree = 1 << degree_bits
    g = gl64.primitive_root_of_unity(degree_bits)

    zeta_pow_n = zeta.pow_const(degree)
    z_h_zeta = zeta_pow_n - ctx.one()
    last = pow(g, P - 2, P)
    z_last = zeta - ctx.constant(last)
    l_first = z_h_zeta * ((zeta - ctx.one()) * ctx.constant(degree)).inv()
    l_last = z_h_zeta * ((zeta - ctx.constant(last))
                         * ctx.constant(degree)).inv()

    vars = StarkEvaluationVars(
        local_values=[E2(v) for v in openings.local_values],
        next_values=[E2(v) for v in openings.next_values],
        public_inputs=[ctx.constant(int(pi)) for pi in public_inputs],
    )
    consumer = ConstraintConsumer(ctx, challenges.stark_alphas, z_last,
                                  l_first, l_last)
    stark.eval_generic(ctx, vars, consumer)
    num_perm = (stark.num_permutation_batches(config)
                if stark.uses_permutation_args() else 0)
    if num_perm:
        eval_permutation_checks(
            ctx, stark, config, vars,
            [E2(v) for v in openings.permutation_ctl_zs[:num_perm]],
            [E2(v) for v in openings.permutation_ctl_zs_next[:num_perm]],
            challenges.permutation_challenge_sets, consumer)
    eval_cross_table_lookup_checks(ctx, vars, ctl_vars, consumer)
    vanishing = consumer.accumulators()

    qdf = stark.quotient_degree_factor()
    for i, v in enumerate(vanishing):
        chunk = openings.quotient_polys[i * qdf:(i + 1) * qdf]
        acc = ctx.zero()
        for c in chunk[::-1]:
            acc = acc * zeta_pow_n + E2(c)
        assert v.equals(z_h_zeta * acc), \
            f"multi-table vanishing check failed (table challenge {i})"

    verify_fri_proof(
        fri_instance_ctl(stark, challenges.stark_zeta, g, degree_bits,
                         num_perm, len(ctl_vars), config),
        openings.to_fri_openings(),
        challenges.fri_challenges,
        [proof.trace_cap, proof.permutation_ctl_zs_cap,
         proof.quotient_polys_cap],
        proof.opening_proof,
        config.fri_params(degree_bits),
    )
