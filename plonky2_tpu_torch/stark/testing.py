"""STARK testing harness (twin of the reference's debug constraint check,
evm/src/prover.rs:529 check_constraints).

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
