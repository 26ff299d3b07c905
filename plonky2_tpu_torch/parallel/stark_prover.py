"""End-to-end distributed STARK prover over a mesh of ranks.

Composes the sharded stages (parallel/prover.py commitment and quotient,
parallel/fri.py FRI commit, fold and query) into one ``prove_sharded()``
that runs trace commitment -> permutation Zs -> quotient -> openings ->
FRI with every large array sharded, and returns a StarkProof
byte-identical to the single-device ``stark/prover.py prove`` (same
transcript, caps, openings and query paths): the mesh analogue of the
reference's pipeline (starky/src/prover.rs:32).

Every rank runs this same function on its own shard; the challenger runs
on every rank and sees only replicated values (caps, openings, the final
polynomial), so the transcript is replicated with no extra communication.
Byte identity holds because every u64 that lands in a proof is
canonicalised, and Poseidon digests depend only on field values, so any
exact re-bracketing of the sums (per-rank partials, halo exchanges)
yields identical bytes.

Sharding per phase:
  * commitment (``sharded_batch_commit``): polynomials sharded for the
    IFFT/LDE (no communication), one all_to_all to row sharding for leaf
    hashing and the local Merkle reduce, an all_gather of the last local
    digest level; the quotient pass's strided natural-order rows ride a
    second all_to_all of 1/step of the matrix.  Leaves, digest levels and
    coefficients never leave their ranks (ShardedMerkleTree).
  * quotient: row-sharded constraint evaluation with a halo for
    next_values (parallel/prover.py); the small (num_challenges, M)
    result is gathered for one coset IFFT on every rank.
  * openings: per-rank polynomial evaluation at zeta (each polynomial
    lives wholly on one rank), gathered as (k, 2) values.
  * FRI composition: alpha-weighted reduce over each oracle's sharded
    coefficients (per-rank partial sums, gathered and summed); the
    division tail runs on every rank (1/num_polys of the work); commit,
    fold and query run sharded (parallel/fri.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl64, gl64ext, ntt
from ..field.extension import GF2
from ..field.goldilocks import GF
from ..field.polynomial import eval_polys_at_ext, powers_ext
from ..fri.oracle import COSET_SHIFT, batch_opening_quotient
from ..iop.challenger import Challenger, permutation_for
from ..stark.proof import (StarkOpeningSet, StarkProof,
                           StarkProofWithPublicInputs)
from ..utils.bits import log2_strict
from ..utils.timing import TimingTree
from .fri import ShardedMerkleTree, sharded_fri_proof
from .mesh import Mesh, all_gather, all_to_all, shard_polys
from .prover import _lde_rows, gather_rows, sharded_stark_quotient_values


class ShardedPolynomialBatch:
    """fri/oracle.py PolynomialBatch twin whose coefficients, LDE leaves
    and Merkle digest levels stay on their ranks.

    coeffs: the rank's block (b, n) of the coefficient rows zero-padded to
    size * b rows (shard_polys); num_polys is the logical count (the pad
    rows are dropped before leaf hashing, so commitments equal the
    unpadded single-device ones).  strided_lde: the rank's block
    (size * b, M / size) of lde[:, ::step], the natural-order quotient
    coset rows of every polynomial, or None.
    """

    def __init__(self, coeffs: GF, num_polys: int,
                 merkle_tree: ShardedMerkleTree, degree_log: int,
                 rate_bits: int, mesh: Mesh, strided_lde: GF | None = None):
        self.coeffs = coeffs
        self.num_polys = num_polys
        self.merkle_tree = merkle_tree
        self.degree_log = degree_log
        self.rate_bits = rate_bits
        self.mesh = mesh
        self.strided_lde = strided_lde

    @property
    def padded_polys(self) -> int:
        return self.coeffs.shape[0] * self.mesh.size

    def eval_at_powers(self, zpow: GF2) -> np.ndarray:
        """Openings at the extension point whose powers table is zpow:
        (num_polys, 2) canonical u64, those of eval_polys_at_ext on the
        whole batch (each polynomial is evaluated whole, on its rank)."""
        r = eval_polys_at_ext(self.coeffs, zpow)
        both = all_gather(torch.stack([r.a.v, r.b.v], dim=-1), self.mesh)
        return GF(both).to_u64()[:self.num_polys]


def sharded_batch_commit(values: GF, rate_bits: int, cap_height: int,
                         mesh: Mesh, from_coeffs: bool = False,
                         quotient_step: int = 0) -> ShardedPolynomialBatch:
    """Distributed PolynomialBatch.from_values / from_coeffs
    (fri/oracle.rs:43-100): polynomial-sharded IFFT and LDE, one
    all_to_all to row-sharded bit-reversed leaves, the local Merkle
    subtree reduce, the gather of the last local level.

    values: the whole (k, n) batch (every rank passes the same; the rank
    takes its block).  quotient_step > 0 also keeps the natural-order
    coset rows lde[:, ::quotient_step], row-sharded (one more all_to_all
    of 1/step of the matrix), for the quotient pass.
    """
    k, n = values.shape
    blk = shard_polys(values, mesh)
    coeffs, lde, rows = _lde_rows(blk, rate_bits, COSET_SHIFT, mesh,
                                  from_coeffs)
    leaves = GF(rows[:k].transpose(0, 1).contiguous())    # pad dropped
    tree = ShardedMerkleTree(leaves, cap_height, mesh)
    strided = None
    if quotient_step:
        strided = GF(all_to_all(lde.v[:, ::quotient_step].contiguous(), mesh))
    return ShardedPolynomialBatch(coeffs, k, tree, log2_strict(n), rate_bits,
                                  mesh, strided)


def _sharded_weighted_sum(coeffs: GF, w_np: np.ndarray, mesh: Mesh) -> GF2:
    """sum_j w[j] * coeffs[j] with extension weights w (k_pad, 2), coeffs
    polynomial-sharded: per-rank partial sums, gathered and summed,
    value-identical to the single-device (polys * apow).sum(axis=0)."""
    b = coeffs.shape[0]
    w = w_np[mesh.rank * b:(mesh.rank + 1) * b]
    wa = GF.from_u64(np.ascontiguousarray(w[:, 0]), mesh.device).reshape(-1, 1)
    wb = GF.from_u64(np.ascontiguousarray(w[:, 1]), mesh.device).reshape(-1, 1)
    part = torch.stack([(coeffs * wa).sum(axis=0).v,
                        (coeffs * wb).sum(axis=0).v])      # (2, n)
    total = GF(all_gather(part.unsqueeze(0), mesh)).sum(axis=0)
    return GF2(total[0], total[1])


def sharded_prove_openings(instance, oracles: list, challenger: Challenger,
                           fri_params, mesh: Mesh,
                           timing: TimingTree | None = None):
    """Distributed PolynomialBatch.prove_openings (fri/oracle.rs:162): the
    alpha-composition reduce runs sharded over each oracle's coefficients;
    the per-batch division (batch_opening_quotient, shared with the
    single-device path) runs on every rank; FRI commit, fold and query run
    sharded (sharded_fri_proof)."""
    timing = timing if timing is not None else TimingTree("openings")
    alpha_np = challenger.get_extension_challenge()
    alpha = GF2.from_u64_pair(alpha_np[0], alpha_np[1], mesh.device)
    n = 1 << fri_params.degree_bits
    subgroup = GF.from_u64(gl64.two_adic_subgroup(fri_params.degree_bits),
                           mesh.device)
    final_poly = None
    with timing.scope("alpha composition + opening quotients"):
        for batch in instance.batches:
            k = len(batch.polynomials)
            apow = np.zeros((k, 2), np.uint64)       # alpha^j, host (tiny)
            acc = gl64ext.ONE
            for j in range(k):
                apow[j] = acc
                acc = gl64ext.mul(acc, alpha_np)
            comp = None
            for oi, oracle in enumerate(oracles):
                w = np.zeros((oracle.padded_polys, 2), np.uint64)
                selected = False
                for j, p in enumerate(batch.polynomials):
                    if p.oracle_index == oi:
                        w[p.polynomial_index] = apow[j]
                        selected = True
                if not selected:
                    continue
                part = _sharded_weighted_sum(oracle.coeffs, w, mesh)
                comp = part if comp is None else comp + part
            z = GF2.from_u64_pair(batch.point[0], batch.point[1], mesh.device)
            quotient = batch_opening_quotient(comp, z, n, subgroup)
            final_poly = quotient if final_poly is None else \
                final_poly * alpha.pow_const(k) + quotient

    with timing.scope("final poly LDE"):
        lde_values = ntt.lde_ext(final_poly, fri_params.config.rate_bits,
                                 shift=COSET_SHIFT)
    with timing.scope("FRI (sharded commit, grind, queries)"):
        return sharded_fri_proof([o.merkle_tree for o in oracles],
                                 lde_values, challenger, fri_params, mesh)


def sharded_quotient_chunks(quotient_values: GF, qdb: int, qdf: int,
                            num_challenges: int, degree: int,
                            mesh: Mesh) -> GF:
    """The quotient's (num_challenges * qdf, degree) coefficient chunks
    from each rank's block of its values: gathered (it is small next to
    the trace), one coset IFFT, the qdf trim."""
    qv = gather_rows(quotient_values, mesh)
    coeffs = ntt.coset_intt(qv, COSET_SHIFT)
    chunks = coeffs.reshape(num_challenges, 1 << qdb, degree)
    return chunks[:, :qdf, :].reshape(num_challenges * qdf, degree)


def prove_sharded(stark, config, trace_poly_values: GF,
                  public_inputs: np.ndarray, mesh: Mesh,
                  timing: TimingTree | None = None) -> StarkProofWithPublicInputs:
    """Distributed twin of stark/prover.py prove: same pipeline, same
    transcript, byte-identical proof.  trace_poly_values: the whole
    (COLUMNS, degree) trace (every rank passes the same)."""
    if config.hasher != "poseidon":
        raise ValueError("the sharded prover commits with device Poseidon")
    timing = timing if timing is not None else TimingTree("prove", mesh.device)
    trace = GF(trace_poly_values.v.to(mesh.device))
    degree = trace.shape[-1]
    degree_bits = log2_strict(degree)
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    if fri_params.total_arities() > degree_bits + rate_bits - cap_height:
        raise ValueError("FRI arities exceed the LDE height above the cap")
    qdb = (stark.quotient_degree_factor() - 1).bit_length()
    if qdb > rate_bits:
        raise ValueError("quotient degree exceeds the blowup")
    step = 1 << (rate_bits - qdb)

    with timing.scope("trace commitment (LDE + Merkle)"):
        trace_commitment = sharded_batch_commit(
            trace, rate_bits, cap_height, mesh, quotient_step=step)
    challenger = Challenger(permutation_for(config.hasher))
    challenger.observe_cap(trace_commitment.merkle_tree.cap)

    # permutation arguments (starky/src/prover.rs:75-112)
    perm_commitment = None
    challenge_sets = None
    if stark.uses_permutation_args():
        from ..stark.permutation import (compute_permutation_z_polys_gf,
                                         get_n_permutation_challenge_sets)
        challenge_sets = get_n_permutation_challenge_sets(
            challenger, config.num_challenges, stark.permutation_batch_size())
        with timing.scope("permutation Z polys"):
            z_polys = compute_permutation_z_polys_gf(
                stark, config, trace, challenge_sets)
        with timing.scope("permutation Z commitment"):
            perm_commitment = sharded_batch_commit(
                z_polys, rate_bits, cap_height, mesh, quotient_step=step)
        challenger.observe_cap(perm_commitment.merkle_tree.cap)

    alphas = challenger.get_n_challenges(config.num_challenges)

    with timing.scope("quotient values + coefficients"):
        perm_rows = (perm_commitment.strided_lde[:perm_commitment.num_polys]
                     if perm_commitment else None)
        quotient_values = sharded_stark_quotient_values(
            stark, trace_commitment.strided_lde[:stark.COLUMNS], alphas,
            degree_bits, qdb, mesh, public_inputs=public_inputs,
            perm_lde=perm_rows, challenge_sets=challenge_sets, config=config)
        chunks = sharded_quotient_chunks(
            quotient_values, qdb, stark.quotient_degree_factor(),
            config.num_challenges, degree, mesh)
    with timing.scope("quotient commitment"):
        quotient_commitment = sharded_batch_commit(
            chunks, rate_bits, cap_height, mesh, from_coeffs=True)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    zeta_np = challenger.get_extension_challenge()
    g = gl64.primitive_root_of_unity(degree_bits)
    with timing.scope("openings at zeta / g*zeta"):
        zeta = GF2.from_u64_pair(zeta_np[0], zeta_np[1], mesh.device)
        zpow = powers_ext(zeta, degree)
        zgpow = powers_ext(zeta * g, degree)
        openings = StarkOpeningSet(
            local_values=trace_commitment.eval_at_powers(zpow),
            next_values=trace_commitment.eval_at_powers(zgpow),
            quotient_polys=quotient_commitment.eval_at_powers(zpow),
            permutation_zs=perm_commitment.eval_at_powers(zpow)
            if perm_commitment else None,
            permutation_zs_next=perm_commitment.eval_at_powers(zgpow)
            if perm_commitment else None,
        )
    for batch in openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)

    commitments = [trace_commitment]
    if perm_commitment is not None:
        commitments.append(perm_commitment)
    commitments.append(quotient_commitment)
    with timing.scope("FRI opening proof"):
        opening_proof = sharded_prove_openings(
            stark.fri_instance(zeta_np, g, config), commitments, challenger,
            fri_params, mesh, timing)

    proof = StarkProof(
        trace_cap=trace_commitment.merkle_tree.cap,
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings,
        opening_proof=opening_proof,
        permutation_zs_cap=perm_commitment.merkle_tree.cap
        if perm_commitment else None,
    )
    return StarkProofWithPublicInputs(proof,
                                      np.asarray(public_inputs, np.uint64))
