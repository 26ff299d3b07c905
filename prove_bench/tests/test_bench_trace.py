"""The benchmark's own trace generator against the program's."""

import numpy as np
import pytest

from prove_bench.statements.fib import fib_trace, fibonacci_numbers

P = 0xFFFFFFFF00000001


def test_fibonacci_numbers_match_the_recurrence():
    f = [1, 0]
    for _ in range(600):
        f.append((f[-1] + f[-2]) % P)
    assert (fibonacci_numbers(600) == np.array(f[:600], dtype=np.uint64)).all()


@pytest.mark.parametrize("x0,x1", [(0, 1), (12345678901234, 2**63 + 5), (P - 1, P - 2)])
def test_trace_matches_generate_trace(x0, x1):
    from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
    rows = 1 << 10
    stark = FibonacciStark(rows)
    want = stark.generate_trace(x0, x1).to_u64()
    got = fib_trace(x0, x1, rows)
    assert got.dtype == np.uint64
    assert (got == want).all()
    assert int(got[1, -1]) == stark.expected_result(x0, x1)
