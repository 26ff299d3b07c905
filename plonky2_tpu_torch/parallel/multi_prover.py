"""End-to-end distributed multi-table STARK prover (the zkEVM pipeline).

Mesh twin of ``stark/multi.py prove_multi_table`` (reference
evm/src/prover.rs:94 prove_with_traces): every per-table phase (trace
commitment, permutation+CTL Z commitment, quotient evaluation, openings
and the FRI opening proof) runs sharded over the mesh, composing the
stages ``parallel/stark_prover.py`` uses for one table:

  * commitments via ``sharded_batch_commit`` (polynomial-sharded IFFT and
    LDE, one all_to_all to row sharding, the Merkle reduce on the ranks);
  * quotient via ``sharded_stark_quotient_values`` in multi-table mode
    (row-sharded constraint evaluation with a halo; permutation and
    cross-table-lookup running-product checks fold into the same
    accumulators);
  * openings at zeta, g zeta and g^(n-1) by per-rank polynomial
    evaluation (``ShardedPolynomialBatch.eval_at_powers``);
  * FRI via ``sharded_prove_openings``.

Replicated on every rank is only what is cross-table or small: the one
shared Fiat-Shamir challenger, the CTL Z columns
(``cross_table_lookup_data_gf``, a scan over every table's trace whose
output is a handful of polynomials) and the permutation Z scan.  The proof
is byte-identical to the single-device ``prove_multi_table``.
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..field.extension import GF2
from ..field.goldilocks import GF
from ..field.polynomial import powers_ext
from ..iop.challenger import Challenger, permutation_for
from ..stark.config import StarkConfig
from ..stark.ctl import get_grand_product_challenge_set
from ..stark.multi import (MultiProof, MultiStarkOpeningSet,
                           MultiTableStarkProof, cross_table_lookup_data_gf,
                           fri_instance_ctl)
from ..stark.permutation import (compute_permutation_z_polys_gf,
                                 get_n_permutation_challenge_sets)
from ..utils.bits import log2_strict
from ..utils.timing import TimingTree
from .mesh import Mesh
from .prover import sharded_stark_quotient_values
from .stark_prover import (sharded_batch_commit, sharded_prove_openings,
                           sharded_quotient_chunks)

P = gl64.ORDER_INT


def _quotient_step(stark, rate_bits: int) -> tuple:
    qdb = (stark.quotient_degree_factor() - 1).bit_length()
    if qdb > rate_bits:
        raise ValueError("quotient degree exceeds the blowup")
    return 1 << (rate_bits - qdb), qdb


def prove_multi_table_sharded(starks: list, ctls: list, config: StarkConfig,
                              trace_poly_values: list,
                              public_inputs: list = None, *, mesh: Mesh,
                              timing: TimingTree | None = None) -> MultiProof:
    """Distributed twin of stark/multi.py prove_multi_table: the same
    shared transcript (all trace caps observed, then the CTL challenges,
    then each table proven in order, evm/src/get_challenges.rs:18), a
    byte-identical MultiProof.  trace_poly_values: per table the whole
    (COLUMNS, n) u64 trace (every rank passes the same)."""
    if config.hasher != "poseidon":
        raise ValueError("the sharded prover commits with device Poseidon")
    timing = timing if timing is not None else TimingTree("prove", mesh.device)
    if public_inputs is None:
        public_inputs = [np.zeros(0, np.uint64)] * len(starks)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height

    traces = [GF.from_u64(t, mesh.device) for t in trace_poly_values]
    with timing.scope("compute all trace commitments (sharded)"):
        trace_commitments = [
            sharded_batch_commit(t, rate_bits, cap_height, mesh,
                                 quotient_step=_quotient_step(s, rate_bits)[0])
            for s, t in zip(starks, traces)]

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
        init_state = challenger.compact()
        with timing.scope(f"prove table {i} ({type(stark).__name__}, sharded)"):
            p = _prove_single_table_sharded(
                stark, config, traces[i], trace_commitments[i],
                ctl_data_per_table[i], public_inputs[i], challenger, mesh,
                timing)
        p.init_challenger_state = init_state
        stark_proofs.append(p)
    return MultiProof(stark_proofs)


def _prove_single_table_sharded(stark, config: StarkConfig, trace: GF,
                                trace_commitment, ctl_data,
                                public_inputs: np.ndarray,
                                challenger: Challenger, mesh: Mesh,
                                timing: TimingTree) -> MultiTableStarkProof:
    """stark/multi.py prove_single_table with every phase on the mesh."""
    degree = trace.shape[-1]
    degree_bits = log2_strict(degree)
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    if fri_params.total_arities() > degree_bits + rate_bits - cap_height:
        raise ValueError("FRI arities exceed the LDE height above the cap")
    if len(ctl_data) == 0:
        raise ValueError(f"no CTL Zs for table {type(stark).__name__}")
    step, qdb = _quotient_step(stark, rate_bits)

    # permutation Zs, then the CTL Zs, share one commitment
    # (evm/src/prover.rs:310)
    challenge_sets = None
    num_perm_zs = 0
    with timing.scope("permutation + CTL Z commitment"):
        z_parts = []
        if stark.uses_permutation_args():
            challenge_sets = get_n_permutation_challenge_sets(
                challenger, config.num_challenges,
                stark.permutation_batch_size())
            perm_zs = compute_permutation_z_polys_gf(stark, config, trace,
                                                     challenge_sets)
            num_perm_zs = perm_zs.shape[0]
            z_parts.append(perm_zs)
        z_parts.append(GF.stack([zc.z for zc in ctl_data.zs_columns]))
        zs_commitment = sharded_batch_commit(
            GF.concatenate(z_parts, axis=0), rate_bits, cap_height, mesh,
            quotient_step=step)
    challenger.observe_cap(zs_commitment.merkle_tree.cap)

    alphas = challenger.get_n_challenges(config.num_challenges)
    with timing.scope("quotient values + coefficients"):
        quotient_values = sharded_stark_quotient_values(
            stark, trace_commitment.strided_lde[:stark.COLUMNS], alphas,
            degree_bits, qdb, mesh, public_inputs=public_inputs,
            perm_lde=zs_commitment.strided_lde[:zs_commitment.num_polys],
            challenge_sets=challenge_sets, config=config,
            num_perm_zs=num_perm_zs, ctl_zs_columns=ctl_data.zs_columns)
        chunks = sharded_quotient_chunks(
            quotient_values, qdb, stark.quotient_degree_factor(),
            config.num_challenges, degree, mesh)
    with timing.scope("quotient commitment"):
        quotient_commitment = sharded_batch_commit(
            chunks, rate_bits, cap_height, mesh, from_coeffs=True)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    zeta_np = challenger.get_extension_challenge()
    g = gl64.primitive_root_of_unity(degree_bits)
    with timing.scope("openings at zeta / g*zeta / g^(n-1)"):
        zeta = GF2.from_u64_pair(zeta_np[0], zeta_np[1], mesh.device)
        zpow = powers_ext(zeta, degree)
        zgpow = powers_ext(zeta * g, degree)
        lastpow = powers_ext(
            GF2.from_u64_pair(np.uint64(pow(g, P - 2, P)), np.uint64(0),
                              mesh.device), degree)
        openings = MultiStarkOpeningSet(
            local_values=trace_commitment.eval_at_powers(zpow),
            next_values=trace_commitment.eval_at_powers(zgpow),
            permutation_ctl_zs=zs_commitment.eval_at_powers(zpow),
            permutation_ctl_zs_next=zs_commitment.eval_at_powers(zgpow),
            ctl_zs_last=zs_commitment.eval_at_powers(
                lastpow)[num_perm_zs:, 0].copy(),
            quotient_polys=quotient_commitment.eval_at_powers(zpow),
        )
    for batch in openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)

    with timing.scope("FRI opening proof"):
        opening_proof = sharded_prove_openings(
            fri_instance_ctl(stark, zeta_np, g, degree_bits, num_perm_zs,
                             len(ctl_data), config),
            [trace_commitment, zs_commitment, quotient_commitment],
            challenger, fri_params, mesh, timing)

    return MultiTableStarkProof(
        trace_cap=trace_commitment.merkle_tree.cap,
        permutation_ctl_zs_cap=zs_commitment.merkle_tree.cap,
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings,
        opening_proof=opening_proof,
        degree_bits=degree_bits,
    )
