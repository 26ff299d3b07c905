"""End-to-end distributed PLONK prover over a mesh of ranks.

Plonk twin of parallel/stark_prover.py: composes the sharded commitment
(sharded_batch_commit), a row-sharded vanishing-polynomial quotient with a
halo for the next-row Z openings, per-rank openings at zeta, and the
sharded FRI (sharded_prove_openings) into one ``prove(mesh=)`` for plonk
circuits (the reference's demo path, plonky2/src/plonk/prover.rs:102, e.g.
the matrix-multiplication example), returning a ProofWithPublicInputs
byte-identical to the single-device plonk/prover.py prove.

Every rank runs it with the same inputs: the witness schedule and the
challenger run on every rank (host work, replicated), the device work is
sharded.  The witness's random wires (the PI gate's unused wires) come from
the schedule's seed, or, for a schedule without one, from a seed that mesh
rank 0 draws afresh for each proof and broadcasts, so every rank commits
the same witness.  Byte identity: every proof u64 is canonicalised at the
boundary and Poseidon digests depend on field values only, so exact
re-bracketing (per-rank partials, halo exchanges, all_to_all layouts)
cannot change a byte.

Sharding per phase:
  * constants/sigmas oracle: re-committed once per (circuit, mesh) as a
    ShardedPolynomialBatch from the prover's stored coefficients (cached on
    the ProverOnlyCircuitData), so its coefficients, LDE leaves and digest
    levels live on the ranks for the quotient, openings and FRI;
  * wires and partial-products/Z commitments: polynomial-sharded IFFT and
    LDE, one all_to_all to row sharding for leaf hashing, strided
    natural-order coset rows kept for the quotient pass;
  * quotient: the vanishing polynomial (gate constraints + permutation
    argument, plonk/vanishing.py eval_vanishing_poly) over the 2^qdb n
    coset, sharded by rows; Z(g x) crosses the shard boundary through a
    2^qdb-row halo; the (nc, 2^qdb n) values are gathered for one small
    coset IFFT;
  * openings at zeta and g zeta: per-rank polynomial evaluation;
  * FRI: alpha composition over sharded coefficients + sharded commit,
    fold and query (parallel/fri.py).

Scope: zero-knowledge blinding (salt columns) and lookup arguments are
single-device only, as in the JAX package; the mesh path raises for both.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..field import gl64
from ..field.extension import GF2
from ..field.goldilocks import GF, batch_inv
from ..field.polynomial import powers_ext
from ..hash.hashing import hash_no_pad_np
from ..iop.challenger import Challenger, permutation_for
from ..plonk.gates.base import BaseBatchCtx, EvalVars
from ..plonk.proof import OpeningSet, Proof, ProofWithPublicInputs
from ..plonk.prover import _all_partial_products_and_zs, _in_subgroup
from ..plonk.vanishing import eval_vanishing_poly
from ..utils.timing import TimingTree
from .mesh import Mesh, broadcast
from .prover import _coset_block, _next_with_halo
from .stark_prover import (sharded_batch_commit, sharded_prove_openings,
                           sharded_quotient_chunks)


def _sharded_constants_sigmas(prover_data, common, step: int, mesh: Mesh):
    """ShardedPolynomialBatch of the preprocessed constants/sigmas oracle,
    built once per (circuit, mesh) from the stored coefficients and cached
    on the ProverOnlyCircuitData (commit-phase work, not per proof)."""
    cache = getattr(prover_data, "_sharded_cs_cache", None)
    if cache is None:
        cache = prover_data._sharded_cs_cache = {}
    key = (mesh.key, step)
    if key not in cache:
        base = prover_data.constants_sigmas_commitment
        cache[key] = sharded_batch_commit(
            GF(base.polynomials.v.to(mesh.device)), base.rate_bits,
            common.config.fri_config.cap_height, mesh, from_coeffs=True,
            quotient_step=step)
    return cache[key]


def _witness_seed(schedule, mesh: Mesh) -> int:
    """The schedule's seed, else one drawn on mesh rank 0 and broadcast."""
    if schedule.rng_seed is not None:
        return schedule.rng_seed
    seed = torch.tensor([secrets.randbits(63)], dtype=torch.int64,
                        device=mesh.device)
    return int(broadcast(seed, mesh)[0])


def _sharded_quotient_values(common, cs_blk: GF, wires_blk: GF, pps_blk: GF,
                             public_inputs_hash, betas, gammas, alphas,
                             mesh: Mesh) -> GF:
    """The rank's block (nc, M / size) of the vanishing polynomial divided
    by Z_H over the quotient coset, from the rank's blocks of the strided
    coset rows."""
    nc = common.config.num_challenges
    num_prods = common.num_partial_products
    qdb = (common.quotient_degree_factor - 1).bit_length()
    n = common.degree()
    xs, zh, zh_inv = _coset_block(common.degree_bits(), qdb, mesh)
    pps_next = _next_with_halo(pps_blk, 1 << qdb, mesh)
    ctx = BaseBatchCtx(mesh.device)
    l_0 = zh * batch_inv((xs - 1) * n)
    vars = EvalVars(
        local_constants=[cs_blk[i] for i in range(common.num_constants)],
        local_wires=[wires_blk[i] for i in range(common.config.num_wires)],
        public_inputs_hash=[ctx.constant(int(h)) for h in public_inputs_hash])
    vanishing = eval_vanishing_poly(
        ctx, common, xs, vars,
        local_zs=[pps_blk[i] for i in range(nc)],
        next_zs=[pps_next[i] for i in range(nc)],
        partial_products=[pps_blk[i] for i in range(nc, nc * (1 + num_prods))],
        s_sigmas=[cs_blk[i] for i in common.sigmas_range()],
        betas=betas, gammas=gammas, alphas=alphas, l_0_x=l_0)
    return GF.stack([v * zh_inv for v in vanishing], axis=0)


def prove_sharded(prover_data, common, inputs, mesh: Mesh,
                  timing: TimingTree | None = None) -> ProofWithPublicInputs:
    """Distributed twin of plonk/prover.py prove: same pipeline, same
    transcript, byte-identical proof."""
    config = common.config
    if config.zero_knowledge:
        raise ValueError("the mesh plonk prover does not shard salt columns")
    if common.has_lookup():
        raise ValueError("the mesh plonk prover does not shard lookup "
                         "polynomials")
    if config.hasher != "poseidon":
        raise ValueError("the sharded prover commits with device Poseidon")
    timing = timing if timing is not None else TimingTree("prove", mesh.device)
    nc = config.num_challenges
    degree = common.degree()
    degree_bits = common.degree_bits()
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    qdb = (common.quotient_degree_factor - 1).bit_length()
    if qdb > rate_bits:
        raise ValueError("quotient degree exceeds the blowup")
    step = 1 << (rate_bits - qdb)

    # 1. witness generation (host, leveled batches; on every rank)
    with timing.scope("generate witness"):
        wires_matrix, all_values = prover_data.schedule.generate(
            inputs, _witness_seed(prover_data.schedule, mesh))
    with timing.scope("hash public inputs"):
        public_inputs = gl64.to_canonical(prover_data.schedule.values_of(
            all_values, prover_data.public_inputs))
        public_inputs_hash = hash_no_pad_np(public_inputs)

    cs_commitment = _sharded_constants_sigmas(prover_data, common, step, mesh)

    # 2. wires commitment (sharded)
    with timing.scope("compute wires commitment"):
        wires_commitment = sharded_batch_commit(
            GF.from_u64(wires_matrix, mesh.device), rate_bits, cap_height,
            mesh, quotient_step=step)

    challenger = Challenger(permutation_for(config.hasher))
    challenger.observe_hash(prover_data.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_commitment.merkle_tree.cap)

    betas = challenger.get_n_challenges(nc)
    gammas = challenger.get_n_challenges(nc)

    # 3. partial products + Z polys: small next to the wires, computed on
    # every rank as in the single-device path, then committed sharded
    with timing.scope("compute partial products"):
        zs_partial_products = _all_partial_products_and_zs(
            wires_matrix, betas, gammas, prover_data, common, mesh.device)
    with timing.scope("commit to partial products and Z's"):
        pp_commitment = sharded_batch_commit(
            zs_partial_products, rate_bits, cap_height, mesh,
            quotient_step=step)
    challenger.observe_cap(pp_commitment.merkle_tree.cap)

    alphas = challenger.get_n_challenges(nc)

    # 4. quotient polynomials: row-sharded vanishing eval over the coset
    with timing.scope("compute quotient polys"):
        quotient_values = _sharded_quotient_values(
            common,
            cs_commitment.strided_lde[:common.num_preprocessed_polys()],
            wires_commitment.strided_lde[:config.num_wires],
            pp_commitment.strided_lde[:pp_commitment.num_polys],
            public_inputs_hash, betas, gammas, alphas, mesh)
        qdf = common.quotient_degree_factor
        chunks = sharded_quotient_chunks(quotient_values, qdb, 1 << qdb, nc,
                                         degree, mesh)
        chunks = chunks.reshape(nc * qdf, degree)
    with timing.scope("commit to quotient polys"):
        quotient_commitment = sharded_batch_commit(
            chunks, rate_bits, cap_height, mesh, from_coeffs=True)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    # 5. openings at zeta, g*zeta (per-rank evals, gathered values)
    zeta_np = challenger.get_extension_challenge()
    if _in_subgroup(zeta_np, degree_bits):
        raise RuntimeError("opening point is in the subgroup")
    with timing.scope("construct the opening set"):
        zeta = GF2.from_u64_pair(zeta_np[0], zeta_np[1], mesh.device)
        zpow = powers_ext(zeta, degree)
        zgpow = powers_ext(zeta * gl64.primitive_root_of_unity(degree_bits),
                           degree)
        cs_eval = cs_commitment.eval_at_powers(zpow)
        pp_eval = pp_commitment.eval_at_powers(zpow)
        cr = common.constants_range()
        sr = common.sigmas_range()
        num_zs_pp = common.num_zs_partial_products_polys()
        openings = OpeningSet(
            constants=cs_eval[cr.start:cr.stop],
            plonk_sigmas=cs_eval[sr.start:sr.stop],
            wires=wires_commitment.eval_at_powers(zpow),
            plonk_zs=pp_eval[:nc],
            plonk_zs_next=pp_commitment.eval_at_powers(zgpow)[:nc],
            partial_products=pp_eval[nc:num_zs_pp],
            quotient_polys=quotient_commitment.eval_at_powers(zpow),
            lookup_zs=pp_eval[num_zs_pp:],
            lookup_zs_next=np.zeros((0, 2), dtype=np.uint64),
        )
    for batch in openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)

    # 6. FRI opening proof (sharded composition + commit/fold/query)
    with timing.scope("compute opening proofs (FRI)"):
        opening_proof = sharded_prove_openings(
            common.get_fri_instance(zeta_np),
            [cs_commitment, wires_commitment, pp_commitment,
             quotient_commitment],
            challenger, common.fri_params, mesh, timing)

    proof = Proof(
        wires_cap=wires_commitment.merkle_tree.cap,
        plonk_zs_partial_products_cap=pp_commitment.merkle_tree.cap,
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputs(proof, public_inputs)
