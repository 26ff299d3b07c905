"""PLONK prover (twin of reference plonk/prover.rs:102-744).

The reference's pipeline, each phase eager torch work on one device (the
device ``CircuitBuilder.build`` committed the circuit on; CUDA unless the
caller named another):
  * witness generation: leveled batched numpy (WitnessSchedule);
  * wire / partial-product / quotient commitments: batched NTT + LDE +
    Merkle (the CUDA kernels on the card);
  * Z and partial products: log-depth prefix products over rows instead of
    the reference's sequential row walk (prover.rs:359);
  * quotient: gate constraints evaluated over the whole 8n coset at once
    (replacing the 32-point packed-SIMD batches of prover.rs:574).
Each phase has a TimingTree scope.  Lookup circuits add the lookup
polynomials (RE and partial SLDC columns, host numpy over the lookup rows)
to the Zs/partial-products commitment and their checks to the quotient.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl64, gl64ext, ntt
from ..field.extension import GF2
from ..field.goldilocks import GF, batch_inv, exclusive_scan
from ..field.polynomial import eval_polys_at_ext, powers_ext
from ..fri.oracle import COSET_SHIFT, PolynomialBatch
from ..hash.hashing import hash_no_pad_np
from ..iop.challenger import Challenger, permutation_for
from ..utils.timing import TimingTree
from .circuit_data import CommonCircuitData, ProverOnlyCircuitData
from .gates.base import BaseBatchCtx, EvalVars
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .vanishing import eval_vanishing_poly
from .witness import PartialWitness

P = gl64.ORDER_INT


def prove(prover_data: ProverOnlyCircuitData, common: CommonCircuitData,
          inputs: PartialWitness, timing: TimingTree | None = None,
          mesh=None) -> ProofWithPublicInputs:
    """Prove on the device that holds the circuit's constants and sigmas.

    mesh: a parallel.mesh.Mesh runs the whole pipeline distributed over
    its ranks (parallel/plonk_prover.py), on the rank's mesh.device, and
    returns a byte-identical proof; every rank calls prove with the same
    arguments."""
    if mesh is not None:
        from ..parallel.plonk_prover import prove_sharded
        return prove_sharded(prover_data, common, inputs, mesh, timing)
    device = prover_data.constants_sigmas_commitment.polynomials.device
    timing = timing if timing is not None else TimingTree("prove", device)
    config = common.config
    num_challenges = config.num_challenges
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    zk = config.zero_knowledge

    # 1. witness generation (host, leveled batches)
    with timing.scope("generate witness"):
        wires_matrix, all_values = prover_data.schedule.generate(inputs)
    with timing.scope("hash public inputs"):
        public_inputs = gl64.to_canonical(prover_data.schedule.values_of(
            all_values, prover_data.public_inputs))
        public_inputs_hash = hash_no_pad_np(public_inputs)

    # 2. wires commitment
    with timing.scope("compute wires commitment"):
        wires_commitment = PolynomialBatch.from_values(
            GF.from_u64(wires_matrix, device), rate_bits, zk, cap_height,
            config.hasher)

    challenger = Challenger(permutation_for(config.hasher))
    challenger.observe_hash(prover_data.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_commitment.merkle_tree.cap)

    betas = challenger.get_n_challenges(num_challenges)
    gammas = challenger.get_n_challenges(num_challenges)
    # lookup deltas: 4 coins per challenge, reusing betas/gammas as the
    # first 2*nc (reference plonk/get_challenges.rs:54-65)
    has_lookup = common.has_lookup()
    if has_lookup:
        extra = challenger.get_n_challenges(2 * num_challenges)
        deltas = np.concatenate([betas, gammas, extra])
    else:
        deltas = np.zeros(0, dtype=np.uint64)

    # 3. partial products + Z polys (prefix products over rows)
    with timing.scope("compute partial products"):
        zs_partial_products = _all_partial_products_and_zs(
            wires_matrix, betas, gammas, prover_data, common, device)
    if has_lookup:
        with timing.scope("compute lookup polys"):
            lookup_polys = _compute_all_lookup_polys(wires_matrix, deltas,
                                                     prover_data, common)
        zs_partial_products = GF.concatenate(
            [zs_partial_products, GF.from_u64(lookup_polys, device)], axis=0)
    with timing.scope("commit to partial products and Z's"):
        pp_commitment = PolynomialBatch.from_values(
            zs_partial_products, rate_bits, zk, cap_height, config.hasher)
    challenger.observe_cap(pp_commitment.merkle_tree.cap)

    alphas = challenger.get_n_challenges(num_challenges)

    # 4. quotient polynomials
    with timing.scope("compute quotient polys"):
        quotient_chunks = _compute_quotient_polys(
            common, prover_data, public_inputs_hash, wires_commitment,
            pp_commitment, betas, gammas, alphas, deltas)
    with timing.scope("commit to quotient polys"):
        quotient_commitment = PolynomialBatch.from_coeffs(
            quotient_chunks, rate_bits, zk, cap_height, config.hasher)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    # 5. openings at zeta, g*zeta
    zeta_np = challenger.get_extension_challenge()
    if _in_subgroup(zeta_np, common.degree_bits()):
        raise RuntimeError("opening point is in the subgroup")
    with timing.scope("construct the opening set"):
        openings = _opening_set(zeta_np, prover_data.constants_sigmas_commitment,
                                wires_commitment, pp_commitment,
                                quotient_commitment, common)
    for batch in openings.to_fri_openings().batches:
        for v in batch.values:
            challenger.observe_extension_element(v)

    instance = common.get_fri_instance(zeta_np)
    with timing.scope("compute opening proofs (FRI)"):
        opening_proof = PolynomialBatch.prove_openings(
            instance,
            [prover_data.constants_sigmas_commitment, wires_commitment,
             pp_commitment, quotient_commitment],
            challenger, common.fri_params, timing)

    proof = Proof(
        wires_cap=wires_commitment.merkle_tree.cap,
        plonk_zs_partial_products_cap=pp_commitment.merkle_tree.cap,
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings,
        opening_proof=opening_proof,
    )
    return ProofWithPublicInputs(proof, public_inputs)


def _in_subgroup(zeta: np.ndarray, degree_bits: int) -> bool:
    z = gl64ext.pow_int(np.asarray(zeta, np.uint64), 1 << degree_bits)
    return bool(gl64ext.equal(z, gl64ext.ONE))


def _all_partial_products_and_zs(wires_matrix: np.ndarray, betas, gammas,
                                 prover_data, common, device) -> GF:
    """GF (num_challenges*(1+num_prods), n): [Z_c ...] ++ [partials_c ...]
    (prover.rs:330-415)."""
    n = common.degree()
    num_routed = common.config.num_routed_wires
    deg = common.quotient_degree_factor
    num_prods = common.num_partial_products

    routed = GF.from_u64(wires_matrix[:num_routed].T, device)   # (n, routed)
    sigmas = GF.from_u64(prover_data.sigmas, device)             # (n, routed)
    x = GF.from_u64(prover_data.subgroup, device).reshape(-1, 1)
    k = GF.from_u64(common.k_is, device).reshape(1, -1)
    s_id = x * k
    zs = []
    partials = []
    for b, g in zip(betas, gammas):
        b, g = int(b), int(g)
        numer = routed + s_id * b + g
        denom = routed + sigmas * b + g
        quotients = numer * batch_inv(denom)                     # (n, routed)
        chunks = quotients.reshape(n, num_prods + 1, deg)
        cp = chunks[:, :, 0]
        for j in range(1, deg):
            cp = cp * chunks[:, :, j]
        row_total = cp[:, 0]
        for j in range(1, num_prods + 1):
            row_total = row_total * cp[:, j]
        z = _exclusive_prefix_product(row_total)                 # Z(x_i)
        run_p = z
        for kk in range(num_prods):
            run_p = run_p * cp[:, kk]
            partials.append(run_p)
        zs.append(z)
    return GF.stack(zs + partials, axis=0)


def _compute_all_lookup_polys(wires_matrix: np.ndarray, deltas: np.ndarray,
                              prover_data, common) -> np.ndarray:
    """(num_challenges * num_lookup_polys, n) u64: per challenge, RE then the
    partial SLDC columns (reference plonk/prover.rs:425-545)."""
    nc = common.config.num_challenges
    out = [
        _compute_lookup_polys(wires_matrix,
                              deltas[4 * i:4 * (i + 1)], prover_data, common)
        for i in range(nc)
    ]
    return np.concatenate(out, axis=0)


def _compute_lookup_polys(wires_matrix: np.ndarray, deltas4: np.ndarray,
                          prover_data, common) -> np.ndarray:
    from .gates.lookup import LookupGate, LookupTableGate

    n = common.degree()
    num_lu_slots = LookupGate.slots_from_config(common.config)
    lu_degree = common.quotient_degree_factor - 1
    num_partial = -(-num_lu_slots // lu_degree)
    num_lut_slots = LookupTableGate.slots_from_config(common.config)
    lut_degree = -(-num_lut_slots // num_partial)

    d_a, d_b, d_alpha, d_delta = (np.uint64(deltas4[i]) for i in range(4))
    polys = np.zeros((num_partial + 1, n), dtype=np.uint64)

    for (last_lu, last_lut, first_lut) in prover_data.lookup_rows:
        # --- LUT region: RE + partial Sums, rows descending ---
        rows = np.arange(last_lut, first_lut + 1)
        inp = wires_matrix[
            [LookupTableGate.wire_ith_looked_inp(s) for s in range(num_lut_slots)]
        ][:, rows]  # (S, R)
        outp = wires_matrix[
            [LookupTableGate.wire_ith_looked_out(s) for s in range(num_lut_slots)]
        ][:, rows]
        mult = wires_matrix[
            [LookupTableGate.wire_ith_multiplicity(s) for s in range(num_lut_slots)]
        ][:, rows]
        looked_combos = gl64.add(inp, gl64.mul(d_a, outp))      # (S, R)
        lookup_combos = gl64.add(inp, gl64.mul(d_b, outp))
        inv_alpha_minus = gl64.batch_inv(gl64.sub(d_alpha, looked_combos))
        weighted = gl64.mul(mult, inv_alpha_minus)              # (S, R)

        # per-row partial sums for each SLDC slot group
        slot_sums = np.zeros((num_partial, len(rows)), dtype=np.uint64)
        for p in range(num_partial):
            for s in range(p * lut_degree,
                           min((p + 1) * lut_degree, num_lut_slots)):
                slot_sums[p] = gl64.add(slot_sums[p], weighted[s])

        for row in range(first_lut, last_lut - 1, -1):
            ri = row - last_lut
            new_re = polys[0][row + 1] if row + 1 < n else np.uint64(0)
            for s in range(num_lut_slots):
                new_re = gl64.add(gl64.mul(new_re, d_delta), lookup_combos[s, ri])
            polys[0][row] = new_re
            for p in range(num_partial):
                prev = polys[num_partial][row + 1] if p == 0 else polys[p][row]
                polys[p + 1][row] = gl64.add(prev, slot_sums[p, ri])

        # --- LU region: partial LDCs, rows descending ---
        rows = np.arange(last_lu, last_lut)
        if len(rows):
            inp = wires_matrix[
                [LookupGate.wire_ith_looking_inp(s) for s in range(num_lu_slots)]
            ][:, rows]
            outp = wires_matrix[
                [LookupGate.wire_ith_looking_out(s) for s in range(num_lu_slots)]
            ][:, rows]
            looking_combos = gl64.add(inp, gl64.mul(d_a, outp))
            inv_looking = gl64.batch_inv(gl64.sub(d_alpha, looking_combos))
            slot_sums = np.zeros((num_partial, len(rows)), dtype=np.uint64)
            for p in range(num_partial):
                for s in range(p * lu_degree,
                               min((p + 1) * lu_degree, num_lu_slots)):
                    slot_sums[p] = gl64.add(slot_sums[p], inv_looking[s])
            for row in range(last_lut - 1, last_lu - 1, -1):
                ri = row - last_lu
                for p in range(num_partial):
                    prev = polys[num_partial][row + 1] if p == 0 else polys[p][row]
                    polys[p + 1][row] = gl64.sub(prev, slot_sums[p, ri])

    return polys


def _exclusive_prefix_product(v: GF) -> GF:
    """[1, v0, v0 v1, ...] along the last axis (log-depth scan)."""
    return GF(exclusive_scan(v.v))


def _compute_quotient_polys(common, prover_data, public_inputs_hash,
                            wires_commitment, pp_commitment, betas, gammas,
                            alphas, deltas) -> GF:
    """Evaluate the vanishing polynomial over the whole quotient coset,
    divide by Z_H, and return the quotient chunks (num_ch*deg_factor, n) as
    coefficients."""
    n = common.degree()
    qdb = (common.quotient_degree_factor - 1).bit_length()   # log2_ceil(8) = 3
    rate_bits = common.config.fri_config.rate_bits
    if qdb > rate_bits:
        raise ValueError("quotient degree exceeds the blowup")
    step = 1 << (rate_bits - qdb)
    next_step = 1 << qdb
    device = wires_commitment.polynomials.device

    # LDE values at natural-order coset points, every `step`th point
    def lde_rows(commitment):
        return GF(commitment.lde_values_natural().v[:, ::step])

    cs = lde_rows(prover_data.constants_sigmas_commitment)
    wires = lde_rows(wires_commitment)
    pps = lde_rows(pp_commitment)
    pps_next = GF(torch.roll(pps.v, -next_step, dims=-1))

    nc = common.config.num_challenges
    ppr = common.partial_products_range()
    lk_start = common.num_zs_partial_products_polys()
    lk_stop = lk_start + common.num_all_lookup_polys()
    ctx = BaseBatchCtx(device)
    # points: shifted big subgroup, natural order
    big_subgroup = gl64.two_adic_subgroup(common.degree_bits() + qdb)
    xs = GF.from_u64(gl64.mul(big_subgroup, np.uint64(COSET_SHIFT)), device)

    # Z_H(x) on the coset has period 2^qdb; L_0(x) = Z_H(x) / (n (x-1))
    zh = _z_h_on_coset(common.degree_bits(), qdb)
    zh_tiled = GF.from_u64(np.tile(zh, n), device)
    l_0 = zh_tiled * batch_inv((xs - 1) * n)

    vars = EvalVars(
        local_constants=[cs[i] for i in range(common.num_constants)],
        local_wires=[wires[i] for i in range(common.config.num_wires)],
        public_inputs_hash=[ctx.constant(int(h)) for h in public_inputs_hash])
    vanishing = eval_vanishing_poly(
        ctx, common, xs, vars,
        local_zs=[pps[i] for i in range(nc)],
        next_zs=[pps_next[i] for i in range(nc)],
        partial_products=[pps[i] for i in range(ppr.start, ppr.stop)],
        s_sigmas=[cs[i] for i in common.sigmas_range()],
        betas=betas, gammas=gammas, alphas=alphas, l_0_x=l_0,
        local_lookup_zs=[pps[i] for i in range(lk_start, lk_stop)],
        next_lookup_zs=[pps_next[i] for i in range(lk_start, lk_stop)],
        deltas=deltas)

    zh_inv_tiled = GF.from_u64(np.tile(gl64.batch_inv(zh), n), device)
    quotient_values = GF.stack([v * zh_inv_tiled for v in vanishing], axis=0)
    quotient_coeffs = ntt.coset_intt(quotient_values, COSET_SHIFT)
    # split into deg_factor chunks of length n each
    return quotient_coeffs.reshape(nc * common.quotient_degree_factor, n)


def _z_h_on_coset(degree_bits: int, qdb: int) -> np.ndarray:
    """Z_H(shift * h^i) = shift^n * (h^n)^i - 1, period 2^qdb
    (reference field/src/zero_poly_coset.rs:7)."""
    n = 1 << degree_bits
    shift_pow_n = gl64.pow_scalar(COSET_SHIFT, n)
    h = gl64.primitive_root_of_unity(degree_bits + qdb)
    h_pow_n = gl64.pow_scalar(h, n)  # primitive 2^qdb-th root
    out = np.empty(1 << qdb, dtype=np.uint64)
    acc = shift_pow_n
    for i in range(1 << qdb):
        out[i] = (acc - 1) % P
        acc = (acc * h_pow_n) % P
    return out


def _opening_set(zeta_np, constants_sigmas_commitment, wires_commitment,
                 pp_commitment, quotient_commitment, common) -> OpeningSet:
    """Evaluate every committed polynomial at zeta (Zs also at g*zeta)."""
    n = common.degree()
    device = wires_commitment.polynomials.device
    zeta = GF2.from_u64_pair(zeta_np[0], zeta_np[1], device)
    zeta_g = zeta * gl64.primitive_root_of_unity(common.degree_bits())

    zpow = powers_ext(zeta, n)
    zgpow = powers_ext(zeta_g, n)

    nc = common.config.num_challenges
    num_zs_pp = common.num_zs_partial_products_polys()

    def at(polys, pw):
        return eval_polys_at_ext(polys, pw).to_u64()

    cs_eval = at(constants_sigmas_commitment.polynomials, zpow)
    pp_eval = at(pp_commitment.polynomials, zpow)
    cr = common.constants_range()
    sr = common.sigmas_range()
    return OpeningSet(
        constants=cs_eval[cr.start:cr.stop],
        plonk_sigmas=cs_eval[sr.start:sr.stop],
        wires=at(wires_commitment.polynomials, zpow),
        plonk_zs=pp_eval[:nc],
        # at g*zeta: the Zs (proof.rs:327)
        plonk_zs_next=at(pp_commitment.polynomials[:nc], zgpow),
        partial_products=pp_eval[nc:num_zs_pp],
        quotient_polys=at(quotient_commitment.polynomials, zpow),
        lookup_zs=pp_eval[num_zs_pp:],
        # at g*zeta: the lookup polys too, if any (proof.rs:327)
        lookup_zs_next=at(pp_commitment.polynomials[num_zs_pp:], zgpow)
        if common.has_lookup() else np.zeros((0, 2), dtype=np.uint64),
    )
