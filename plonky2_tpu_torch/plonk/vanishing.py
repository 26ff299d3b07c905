"""Vanishing-polynomial evaluation, generic over the field context.

Twin of reference plonk/vanishing_poly.rs:54-230 (`eval_vanishing_poly` /
`eval_vanishing_poly_base_batch`).  One field-polymorphic implementation:
the prover calls it with device GF arrays spanning the whole quotient coset
(replacing the reference's 32-point packed-SIMD batches), the verifier with
host E2 extension scalars at zeta.

Constraint ordering (must match for alpha-combination parity):
  [L_0(x)(Z(x)-1) per challenge] ++ [partial-product checks per challenge]
  ++ [filtered gate constraints].
"""

from __future__ import annotations

import numpy as np

from .gates.base import EvalVars

UNUSED_SELECTOR = (1 << 32) - 1  # u32::MAX (gates/selectors.rs:14)


def _elem(ctx, v):
    """Lift a host integer challenge to a ctx element; pass elements through.

    Lets one implementation serve the prover/verifier (integer challenges)
    and the recursive verifier (challenges are circuit targets)."""
    if isinstance(v, (int, np.integer)):
        return ctx.constant(int(v))
    return v


def compute_filter(ctx, row: int, group: range, s, many_selectors: bool):
    """prod over {i in group, i != row} (+UNUSED if many) of (i - s)
    (reference gates/gate.rs:277)."""
    acc = None
    idxs = [i for i in group if i != row]
    if many_selectors:
        idxs.append(UNUSED_SELECTOR)
    for i in idxs:
        term = ctx.constant(i) - s
        acc = term if acc is None else acc * term
    return acc if acc is not None else ctx.one()


def evaluate_gate_constraints(ctx, common, vars: EvalVars) -> list:
    """Filtered sum of all gate constraints (vanishing_poly.rs:675)."""
    num_selectors = common.selectors_info.num_selectors()
    num_lookup_selectors = getattr(common, "num_lookup_selectors", 0)
    constraints = [None] * common.num_gate_constraints
    for i, gate in enumerate(common.gates):
        sel_idx = common.selectors_info.selector_indices[i]
        group = common.selectors_info.groups[sel_idx]
        filt = compute_filter(ctx, i, group, vars.local_constants[sel_idx],
                              num_selectors > 1)
        inner_vars = EvalVars(
            local_constants=vars.local_constants[num_selectors
                                                 + num_lookup_selectors:],
            local_wires=vars.local_wires,
            public_inputs_hash=vars.public_inputs_hash,
        )
        for j, c in enumerate(gate.eval_unfiltered(ctx, inner_vars)):
            fc = filt * c
            constraints[j] = fc if constraints[j] is None else constraints[j] + fc
    return [c if c is not None else ctx.zero() for c in constraints]


def check_partial_products(numerators, denominators, partials, z_x, z_gx,
                           max_degree: int) -> list:
    """acc_{i} * prod(num_chunk) - acc_{i+1} * prod(den_chunk) per chunk
    (reference util/partial_products.rs:52)."""
    accs = [z_x] + list(partials) + [z_gx]
    out = []
    for ci, start in enumerate(range(0, len(numerators), max_degree)):
        nume = numerators[start:start + max_degree]
        deno = denominators[start:start + max_degree]
        nprod = nume[0]
        for t in nume[1:]:
            nprod = nprod * t
        dprod = deno[0]
        for t in deno[1:]:
            dprod = dprod * t
        out.append(accs[ci] * nprod - accs[ci + 1] * dprod)
    return out


def get_lut_poly_eval(ctx, common, lut_index: int, b, delta, degree: int):
    """Evaluate the LUT's fingerprint polynomial at delta
    (vanishing_poly.rs:31 get_lut_poly + eval): Horner over padded entries in
    entry order, each coefficient (in_i + b * out_i)."""
    lut = common.luts[lut_index]
    acc = ctx.zero()
    for i in range(degree):
        if i < len(lut):
            a_c, o_c = lut[i]
            coeff = ctx.constant(a_c) + b * ctx.constant(o_c)
        else:
            coeff = ctx.zero()
        acc = acc * delta + coeff
    return acc


def check_lookup_constraints(ctx, common, vars: EvalVars, local_lookup_zs,
                             next_lookup_zs, lookup_selectors, deltas) -> list:
    """logUp constraint checks (vanishing_poly.rs:330-505).

    RE checks LUT well-formation; the SLDC columns carry partial Sum
    (multiplicity-weighted) then partial LDC (looking) running sums, sharing
    storage so the final constraint is simply SLDC(end) = 0."""
    from .gates.lookup import LookupGate, LookupTableGate

    num_lu_slots = LookupGate.slots_from_config(common.config)
    num_lut_slots = LookupTableGate.slots_from_config(common.config)
    lu_degree = common.quotient_degree_factor - 1
    num_sldc = common.num_lookup_polys - 1
    lut_degree = -(-num_lut_slots // num_sldc)

    delta_a = deltas[0]
    delta_b = deltas[1]
    delta_alpha = deltas[2]
    delta_delta = deltas[3]

    z_re = local_lookup_zs[0]
    next_z_re = next_lookup_zs[0]
    z_sldc = local_lookup_zs[1:]
    z_next_sldc = next_lookup_zs[1:]

    w = vars.local_wires
    looked_combos = [w[LookupTableGate.wire_ith_looked_inp(s)]
                     + delta_a * w[LookupTableGate.wire_ith_looked_out(s)]
                     for s in range(num_lut_slots)]
    looking_combos = [w[LookupGate.wire_ith_looking_inp(s)]
                      + delta_a * w[LookupGate.wire_ith_looking_out(s)]
                      for s in range(num_lu_slots)]
    lookup_combos = [w[LookupTableGate.wire_ith_looked_inp(s)]
                     + delta_b * w[LookupTableGate.wire_ith_looked_out(s)]
                     for s in range(num_lut_slots)]

    constraints = []
    # last LDC value must be 0; initial Sum and RE must be 0
    constraints.append(lookup_selectors[3] * z_sldc[num_sldc - 1])
    constraints.append(lookup_selectors[2] * z_sldc[0])
    constraints.append(lookup_selectors[2] * z_re)

    # final RE value must equal the LUT fingerprint, per LUT
    num_shared = 4
    for r in range(num_shared, common.num_lookup_selectors):
        lut_index = r - num_shared
        lut_rows = -(-len(common.luts[lut_index]) // num_lut_slots)
        fingerprint = get_lut_poly_eval(ctx, common, lut_index, delta_b,
                                        delta_delta, num_lut_slots * lut_rows)
        constraints.append(lookup_selectors[r] * (z_re - fingerprint))

    # RE row transition
    cur_sum = next_z_re
    for elt in lookup_combos:
        cur_sum = cur_sum * delta_delta + elt
    constraints.append(lookup_selectors[0] * (z_re - cur_sum))

    for poly in range(num_sldc):
        lut_range = range(poly * lut_degree,
                          min((poly + 1) * lut_degree, num_lut_slots))
        lu_range = range(poly * lu_degree,
                         min((poly + 1) * lu_degree, num_lu_slots))

        lut_terms = [delta_alpha - looked_combos[i] for i in lut_range]
        lu_terms = [delta_alpha - looking_combos[i] for i in lu_range]

        def prod(terms):
            acc = None
            for t in terms:
                acc = t if acc is None else acc * t
            return acc if acc is not None else ctx.one()

        lut_prod = prod(lut_terms)
        lu_prod = prod(lu_terms)

        def sum_prods_excl(terms, weights=None):
            total = None
            for i in range(len(terms)):
                p = prod(terms[:i] + terms[i + 1:])
                if weights is not None:
                    p = weights[i] * p
                total = p if total is None else total + p
            return total if total is not None else ctx.zero()

        lu_sum_prods = sum_prods_excl(lu_terms)
        mults = [w[LookupTableGate.wire_ith_multiplicity(i)] for i in lut_range]
        lut_sum_prods_mul = sum_prods_excl(lut_terms, mults)

        prev = z_next_sldc[num_sldc - 1] if poly == 0 else z_sldc[poly - 1]
        # Sum transition: lut_prod * (z - prev) = sum_i m_i prod_{j!=i}
        constraints.append(lookup_selectors[0]
                           * (lut_prod * (z_sldc[poly] - prev) - lut_sum_prods_mul))
        # LDC transition: lu_prod * (z - prev) = -sum_i prod_{j!=i}
        constraints.append(lookup_selectors[1]
                           * (lu_prod * (z_sldc[poly] - prev) + lu_sum_prods))

    return constraints


def eval_vanishing_poly(ctx, common, x, vars: EvalVars, local_zs, next_zs,
                        partial_products, s_sigmas, betas, gammas, alphas,
                        l_0_x, local_lookup_zs=None, next_lookup_zs=None,
                        deltas=None) -> list:
    """Returns one combined value per alpha challenge.

    x: the evaluation point (element); l_0_x: L_0(x) precomputed (element);
    betas/gammas/alphas: python ints (base-field challenges);
    local_zs/next_zs: list per challenge; partial_products: flat list
    (num_challenges * num_partial_products); s_sigmas: list per routed wire.
    """
    max_degree = common.quotient_degree_factor
    num_prods = common.num_partial_products
    num_routed = common.config.num_routed_wires
    has_lookup = getattr(common, "num_lookup_polys", 0) != 0

    constraint_terms = evaluate_gate_constraints(ctx, common, vars)

    if has_lookup:
        num_selectors = common.selectors_info.num_selectors()
        lookup_selectors = vars.local_constants[
            num_selectors:num_selectors + common.num_lookup_selectors]

    vanishing_z_1_terms = []
    vanishing_all_lookup_terms = []
    vanishing_partial_products_terms = []

    for i in range(common.config.num_challenges):
        z_x = local_zs[i]
        z_gx = next_zs[i]
        vanishing_z_1_terms.append(l_0_x * (z_x - ctx.one()))

        if has_lookup:
            nlp = common.num_lookup_polys
            cur_deltas = [_elem(ctx, d) for d in deltas[4 * i:4 * (i + 1)]]
            vanishing_all_lookup_terms.extend(check_lookup_constraints(
                ctx, common, vars, local_lookup_zs[nlp * i:nlp * (i + 1)],
                next_lookup_zs[nlp * i:nlp * (i + 1)], lookup_selectors,
                cur_deltas))

        beta = _elem(ctx, betas[i])
        gamma = _elem(ctx, gammas[i])
        numerators = []
        denominators = []
        for j in range(num_routed):
            wire = vars.local_wires[j]
            # wire + beta * k_j * x + gamma
            numerators.append(
                wire + x * (beta * ctx.constant(int(common.k_is[j]))) + gamma)
            denominators.append(
                wire + s_sigmas[j] * beta + gamma)

        cur_partials = partial_products[i * num_prods:(i + 1) * num_prods]
        vanishing_partial_products_terms.extend(
            check_partial_products(numerators, denominators, cur_partials,
                                   z_x, z_gx, max_degree))

    terms = (vanishing_z_1_terms + vanishing_all_lookup_terms
             + vanishing_partial_products_terms + constraint_terms)

    # reduce_with_powers_multi (plonk_common.rs:97): Horner from the last term
    out = []
    for a in alphas:
        alpha_c = _elem(ctx, a)
        acc = ctx.zero()
        for t in reversed(terms):
            acc = acc * alpha_c + t
        out.append(acc)
    return out


_P = 0xFFFFFFFF00000001
