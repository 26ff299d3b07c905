"""STARK testing harnesses (twin of reference starky/src/stark_testing.rs
and of the debug constraint check, evm/src/prover.rs:529).

``test_stark_low_degree`` applies the AIR to random low-degree witness
polynomials and checks that the combined constraint stays within the
declared degree bound (its interpolation runs on ``device``, CUDA unless
the caller names another); ``test_stark_circuit_constraints`` checks that
the in-circuit constraint evaluation (CircuitCtx, the witness schedule)
agrees with the host evaluation on random inputs;
``check_constraints_on_trace`` evaluates a table's AIR on a purportedly
valid trace over the subgroup itself, on host numpy (field/gl64ext V64),
and raises AssertionError on the first rows that violate it.
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..field.gl64ext import V64, V64Ctx
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

P = gl64.ORDER_INT
WITNESS_SIZE = 1 << 5


def _eval_poly_grid(coeffs: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """(k, c) coeffs evaluated at (m,) points -> (k, m), Horner."""
    out = np.zeros((coeffs.shape[0], len(xs)), dtype=np.uint64)
    for j in range(coeffs.shape[1] - 1, -1, -1):
        out = gl64.add(gl64.mul(out, xs), coeffs[:, j:j + 1])
    return out


def _degree_of_values(values: np.ndarray, device) -> int:
    """Degree of the polynomial interpolating `values` on the subgroup."""
    from ..field import ntt
    from ..field.goldilocks import GF
    from ..utils.cuda import resolve_device
    coeffs = ntt.intt(GF.from_u64(values, resolve_device(device))).to_u64()
    nz = np.flatnonzero(coeffs)
    return int(nz[-1]) if len(nz) else 0


def test_stark_low_degree(stark: Stark, rng=None, device=None) -> None:
    """stark_testing.rs:23 — random low-degree witness, LDE, degree check."""
    rng = rng or np.random.default_rng(0)
    rate_bits = max((stark.constraint_degree() + 1 - 1).bit_length(), 1)
    size = WITNESS_SIZE << rate_bits
    log_size = size.bit_length() - 1

    coeffs = rng.integers(0, P, size=(stark.COLUMNS, WITNESS_SIZE),
                          dtype=np.uint64)
    big = gl64.two_adic_subgroup(log_size)
    trace = _eval_poly_grid(coeffs, big)  # (COLUMNS, size)
    trace_next = np.roll(trace, -(1 << rate_bits), axis=1)

    public_inputs = rng.integers(0, P, size=stark.PUBLIC_INPUTS,
                                 dtype=np.uint64)

    # L_0 and L_{n-1} of the SMALL subgroup, evaluated on the big one:
    # L_k(x) = (1/n) sum_j (g^{-k} x)^j
    g_small = gl64.primitive_root_of_unity(WITNESS_SIZE.bit_length() - 1)
    n_inv = pow(WITNESS_SIZE, P - 2, P)

    def lagrange(k):
        gk_inv = pow(pow(g_small, k, P), P - 2, P)  # g^{-k}
        scaled = gl64.mul(big, np.uint64(gk_inv))
        acc = np.zeros(size, dtype=np.uint64)
        pw = np.ones(size, dtype=np.uint64)
        for _ in range(WITNESS_SIZE):
            acc = gl64.add(acc, pw)
            pw = gl64.mul(pw, scaled)
        return gl64.mul(acc, np.uint64(n_inv))

    lag_first = lagrange(0)
    lag_last = lagrange(WITNESS_SIZE - 1)
    last = pow(g_small, P - 2, P)
    z_last = gl64.sub(big, np.uint64(last))

    ctx = V64Ctx()
    alpha = int(rng.integers(1, P, dtype=np.uint64))
    vars = StarkEvaluationVars(
        local_values=[V64(trace[i]) for i in range(stark.COLUMNS)],
        next_values=[V64(trace_next[i]) for i in range(stark.COLUMNS)],
        public_inputs=[ctx.constant(int(pi)) for pi in public_inputs],
    )
    consumer = ConstraintConsumer(ctx, [alpha], V64(z_last), V64(lag_first),
                                  V64(lag_last))
    stark.eval_generic(ctx, vars, consumer)
    combined = consumer.accumulators()[0].v

    degree = _degree_of_values(np.broadcast_to(combined, (size,)), device)
    maximum = WITNESS_SIZE * stark.constraint_degree() - 1
    assert degree <= maximum, \
        f"constraint degree {degree} exceeds bound {maximum}"


def check_constraints_on_trace(stark: Stark, trace: np.ndarray,
                               public_inputs=(), rng=None) -> None:
    """Every constraint vanishes on a purportedly-valid trace — the host
    analogue of the reference's debug `check_constraints`
    (evm/src/prover.rs:529), evaluated on H itself rather than the LDE
    coset.  trace: (COLUMNS, n) u64 subgroup evaluations."""
    rng = rng or np.random.default_rng(1)
    n = trace.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    g = gl64.primitive_root_of_unity(log_n)
    xs = gl64.two_adic_subgroup(log_n)
    z_last = gl64.sub(xs, np.uint64(pow(g, P - 2, P)))
    lag_first = np.zeros(n, np.uint64)
    lag_first[0] = 1
    lag_last = np.zeros(n, np.uint64)
    lag_last[-1] = 1

    ctx = V64Ctx()
    alpha = int(rng.integers(1, P, dtype=np.uint64))
    vars = StarkEvaluationVars(
        local_values=[V64(trace[i]) for i in range(stark.COLUMNS)],
        next_values=[V64(np.roll(trace[i], -1)) for i in range(stark.COLUMNS)],
        public_inputs=[ctx.constant(int(pi)) for pi in public_inputs],
    )
    consumer = ConstraintConsumer(ctx, [alpha], V64(z_last), V64(lag_first),
                                  V64(lag_last))
    stark.eval_generic(ctx, vars, consumer)
    acc = gl64.to_canonical(
        np.broadcast_to(consumer.accumulators()[0].v, (n,)))
    bad = np.nonzero(acc)[0]
    assert len(bad) == 0, f"AIR violated on rows {bad[:8].tolist()}"


def test_stark_circuit_constraints(stark: Stark, config=None, rng=None,
                                   device=None) -> None:
    """stark_testing.rs:81 — circuit constraint evaluation must agree with
    the host (extension-scalar) evaluation on random inputs.  The circuit
    is built for ``device``; its witness schedule runs on the host."""
    from ..field.gl64ext import E2
    from ..plonk.builder import CircuitBuilder
    from ..plonk.config import CircuitConfig
    from ..plonk.gates.base import ExtCtx
    from ..plonk.witness import PartialWitness
    from ..recursion.ctx import CircuitCtx

    rng = rng or np.random.default_rng(0)

    def rand_ext():
        return rng.integers(0, P, size=2, dtype=np.uint64)

    locals_v = [rand_ext() for _ in range(stark.COLUMNS)]
    nexts_v = [rand_ext() for _ in range(stark.COLUMNS)]
    pis_v = [int(rng.integers(0, P, dtype=np.uint64))
             for _ in range(stark.PUBLIC_INPUTS)]
    alpha_v = int(rng.integers(1, P, dtype=np.uint64))
    z_last_v, lag_first_v, lag_last_v = rand_ext(), rand_ext(), rand_ext()

    # host evaluation over E2 scalars
    hctx = ExtCtx()
    hvars = StarkEvaluationVars(
        local_values=[E2(v) for v in locals_v],
        next_values=[E2(v) for v in nexts_v],
        public_inputs=[hctx.constant(v) for v in pis_v],
    )
    hcons = ConstraintConsumer(hctx, [alpha_v], E2(z_last_v), E2(lag_first_v),
                               E2(lag_last_v))
    stark.eval_generic(hctx, hvars, hcons)
    expected = hcons.accumulators()[0]

    # circuit evaluation
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    ctx = CircuitCtx(b)
    lt = b.add_virtual_extension_targets(stark.COLUMNS)
    nt = b.add_virtual_extension_targets(stark.COLUMNS)
    pit = b.add_virtual_targets(stark.PUBLIC_INPUTS)
    alpha_t = b.add_virtual_target()
    zl_t = b.add_virtual_extension_target()
    lf_t = b.add_virtual_extension_target()
    ll_t = b.add_virtual_extension_target()
    cvars = StarkEvaluationVars(
        local_values=[ctx.wrap(t) for t in lt],
        next_values=[ctx.wrap(t) for t in nt],
        public_inputs=[ctx.wrap_base(t) for t in pit],
    )
    ccons = ConstraintConsumer(ctx, [ctx.wrap_base(alpha_t)], ctx.wrap(zl_t),
                               ctx.wrap(lf_t), ctx.wrap(ll_t))
    stark.eval_generic(ctx, cvars, ccons)
    out = ccons.accumulators()[0].t
    b.register_public_input(out[0])
    b.register_public_input(out[1])
    data = b.build(device)

    pw = PartialWitness()
    for t, v in zip(lt, locals_v):
        pw.set_target(t[0], int(v[0]))
        pw.set_target(t[1], int(v[1]))
    for t, v in zip(nt, nexts_v):
        pw.set_target(t[0], int(v[0]))
        pw.set_target(t[1], int(v[1]))
    for t, v in zip(pit, pis_v):
        pw.set_target(t, v)
    pw.set_target(alpha_t, alpha_v)
    for t, v in [(zl_t, z_last_v), (lf_t, lag_first_v), (ll_t, lag_last_v)]:
        pw.set_target(t[0], int(v[0]))
        pw.set_target(t[1], int(v[1]))

    _, all_values = data.prover_only.schedule.generate(pw)
    got = data.prover_only.schedule.values_of(all_values, [out[0], out[1]])
    assert expected.equals(E2(gl64.to_canonical(got))), \
        "circuit constraint evaluation disagrees with host evaluation"
