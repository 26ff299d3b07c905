"""FibonacciStark example AIR (twin of reference starky/src/fibonacci_stark.rs:22)."""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..field.goldilocks import GF
from .stark import ConstraintConsumer, Stark, StarkEvaluationVars

P = gl64.ORDER_INT


class FibonacciStark(Stark):
    COLUMNS = 4
    PUBLIC_INPUTS = 3
    PI_INDEX_X0 = 0
    PI_INDEX_X1 = 1
    PI_INDEX_RES = 2

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def generate_trace(self, x0: int, x1: int) -> GF:
        """(COLUMNS, num_rows) trace values, on the host (CPU) device."""
        rows = np.zeros((self.num_rows, 4), dtype=np.uint64)
        acc = [x0 % P, x1 % P, 0, 1]
        for i in range(self.num_rows):
            rows[i] = acc
            acc = [acc[1], (acc[0] + acc[1]) % P, (acc[2] + 1) % P, (acc[3] + 1) % P]
        rows[self.num_rows - 1][3] = 0  # columns 2/3 are permutations
        return GF.from_u64(rows.T.copy(), "cpu")

    def expected_result(self, x0: int, x1: int) -> int:
        a, b = x0 % P, x1 % P
        for _ in range(self.num_rows - 1):
            a, b = b, (a + b) % P
        return b

    def eval_generic(self, ctx, vars: StarkEvaluationVars,
                     yield_constr: ConstraintConsumer) -> None:
        yield_constr.constraint_first_row(
            vars.local_values[0] - vars.public_inputs[self.PI_INDEX_X0])
        yield_constr.constraint_first_row(
            vars.local_values[1] - vars.public_inputs[self.PI_INDEX_X1])
        yield_constr.constraint_last_row(
            vars.local_values[1] - vars.public_inputs[self.PI_INDEX_RES])
        # x0' <- x1
        yield_constr.constraint_transition(
            vars.next_values[0] - vars.local_values[1])
        # x1' <- x0 + x1
        yield_constr.constraint_transition(
            vars.next_values[1] - vars.local_values[0] - vars.local_values[1])

    def constraint_degree(self) -> int:
        return 2

    def permutation_pairs(self) -> list:
        """Columns 2 and 3 are [0..n-1] and [1..n-1, 0] — permutations of
        each other (reference fibonacci_stark.rs permutation_pairs)."""
        from .permutation import PermutationPair
        return [PermutationPair.singletons(2, 3)]
