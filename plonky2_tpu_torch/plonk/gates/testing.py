"""Gate test harness (twin of reference gates/gate_testing.rs:24-120).

`check_low_degree`: feed the gate random *low-degree* wire/constant
polynomials, evaluate its constraints pointwise over a large subgroup
(torch GF arrays on ``device``), interpolate, and assert the constraint
degree is within (witness_degree * gate.degree()).

`check_eval_consistency`: the same random point evaluated through the
prover's base-field context and the verifier's extension context must agree
(replaces half of the reference's test_eval_fns; the circuit-eval third
lands with the recursive verifier).

Both run on the CUDA device unless the caller names another.
"""

from __future__ import annotations

import numpy as np

from ...field import gl64, ntt
from ...field.gl64ext import E2
from ...field.goldilocks import GF
from ...utils.bits import log2_ceil
from ...utils.cuda import resolve_device
from .base import BaseBatchCtx, EvalVars, ExtCtx

P = gl64.ORDER_INT


def check_low_degree(gate, seed: int = 0, witness_size: int = 8,
                     device=None) -> None:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    rate_bits = log2_ceil(max(gate.degree(), 1) + 1)

    wire_coeffs = rng.integers(0, P, size=(max(gate.num_wires(), 1), witness_size),
                               dtype=np.uint64)
    const_coeffs = rng.integers(0, P, size=(max(gate.num_constants(), 1), witness_size),
                                dtype=np.uint64)
    wire_values = ntt.lde(GF.from_u64(wire_coeffs, device), rate_bits)
    const_values = ntt.lde(GF.from_u64(const_coeffs, device), rate_bits)
    pis_hash = [GF.full((), int(x), device)
                for x in rng.integers(0, P, 4, dtype=np.uint64)]

    vars = EvalVars(
        local_constants=[const_values[i] for i in range(gate.num_constants())],
        local_wires=[wire_values[i] for i in range(gate.num_wires())],
        public_inputs_hash=pis_hash,
    )
    constraints = gate.eval_unfiltered(BaseBatchCtx(device), vars)
    assert len(constraints) == gate.num_constraints(), \
        f"{gate.id()}: num_constraints() = {gate.num_constraints()} but eval returned {len(constraints)}"
    if not constraints:
        return
    n = witness_size << rate_bits
    coeffs = ntt.intt(GF.stack([c.broadcast_to((n,)) for c in constraints],
                               axis=0)).to_u64()
    max_degree_allowed = (witness_size - 1) * gate.degree()
    bad = np.nonzero(coeffs[:, max_degree_allowed + 1:].any(axis=1))[0]
    assert bad.size == 0, (
        f"{gate.id()}: constraints {bad.tolist()} exceed degree "
        f"{gate.degree()} (witness deg {witness_size - 1})")


def check_eval_consistency(gate, seed: int = 1, device=None) -> None:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    wires = rng.integers(0, P, size=max(gate.num_wires(), 1), dtype=np.uint64)
    consts = rng.integers(0, P, size=max(gate.num_constants(), 1), dtype=np.uint64)
    pis = rng.integers(0, P, size=4, dtype=np.uint64)

    base_vars = EvalVars(
        local_constants=[GF.from_u64(np.array([c]), device) for c in consts],
        local_wires=[GF.from_u64(np.array([w]), device) for w in wires],
        public_inputs_hash=[GF.full((1,), int(x), device) for x in pis],
    )
    base_out = gate.eval_unfiltered(BaseBatchCtx(device), base_vars)

    ext_vars = EvalVars(
        local_constants=[E2.of(int(c)) for c in consts],
        local_wires=[E2.of(int(w)) for w in wires],
        public_inputs_hash=[E2.of(int(x)) for x in pis],
    )
    ext_out = gate.eval_unfiltered(ExtCtx(), ext_vars)

    assert len(base_out) == len(ext_out) == gate.num_constraints()
    for i, (b, e) in enumerate(zip(base_out, ext_out)):
        bv = int(b.to_u64().reshape(-1)[0])
        ev = e.v
        assert int(gl64.to_canonical(ev[0])) == bv and int(gl64.to_canonical(ev[1])) == 0, \
            f"{gate.id()}: constraint {i} differs between base and ext eval"
