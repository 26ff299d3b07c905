"""The Fibonacci STARK, plainly: its statement's public values and a
verifier of its proofs (reference starky src/fibonacci_stark.rs,
src/verifier.rs, src/permutation.rs), in numpy.

The AIR has 4 columns: x0, x1 (the sequence), and two columns that are
permutations of each other ([0..n-1] and [1..n-1, 0]).  Public inputs:
x0, x1 and the last row's x1.  Constraints: the first row holds the public
x0 and x1, the last row's x1 the result, each row steps (x0, x1) to
(x1, x0 + x1), and one permutation argument ties columns 2 and 3, with a Z
column per challenge.  The constraint degree is 2, so each challenge has
one quotient chunk.

A proof comes as a plain record:

    {"public_inputs": (3,), "trace_cap", "perm_cap", "quotient_cap":
     (2^h, 4), "openings": {"local", "next", "perm", "perm_next",
     "quotient": (k, 2)}, "fri": a FRI record (fri.py)}
"""

from __future__ import annotations

import numpy as np

from . import gl64
from .fri import Batch, FriParams, Rejected, challenges, ensure, observe_openings
from .fri import verify as verify_fri
from .gl64ext import E2
from .hashing import Challenger

P = gl64.ORDER_INT
COLUMNS = 4
PERM_PAIR = (2, 3)


def fib_result(x0: int, x1: int, rows: int) -> int:
    """x1 of the last row: F after rows - 1 steps, by doubling the step
    matrix [[0, 1], [1, 1]]."""
    def mat_mul(a, b):
        return [[(a[0][0] * b[0][0] + a[0][1] * b[1][0]) % P,
                 (a[0][0] * b[0][1] + a[0][1] * b[1][1]) % P],
                [(a[1][0] * b[0][0] + a[1][1] * b[1][0]) % P,
                 (a[1][0] * b[0][1] + a[1][1] * b[1][1]) % P]]
    result, base, e = [[1, 0], [0, 1]], [[0, 1], [1, 1]], rows - 1
    while e:
        if e & 1:
            result = mat_mul(result, base)
        base = mat_mul(base, base)
        e >>= 1
    # (a_k, b_k) = M^k (x0, x1)
    return (result[1][0] * x0 + result[1][1] * x1) % P


def public_inputs(x0: int, x1: int, rows: int) -> np.ndarray:
    return np.array([x0 % P, x1 % P, fib_result(x0, x1, rows)], dtype=np.uint64)


def verify(proof: dict, config: dict, rows: int) -> None:
    """Raises Rejected unless the proof verifies for `rows` rows under the
    configuration's parameters."""
    degree_bits = rows.bit_length() - 1
    ensure(1 << degree_bits == rows, "rows is not a power of two")
    params = FriParams.from_config(config["fri"], degree_bits)
    nc = config["num_challenges"]
    h = params.cap_height
    o = proof["openings"]
    for name in ("trace_cap", "perm_cap", "quotient_cap"):
        ensure(np.shape(proof[name]) == (1 << h, 4), f"{name} has the wrong size")
    for name, k in (("local", COLUMNS), ("next", COLUMNS), ("perm", nc),
                    ("perm_next", nc), ("quotient", nc)):
        ensure(np.shape(o[name]) == (k, 2), f"wrong number of {name} openings")
    ensure(np.shape(proof["public_inputs"]) == (3,), "wrong number of public inputs")

    ch = Challenger()
    ch.observe_cap(proof["trace_cap"])
    # one set of num_challenges (beta, gamma) pairs: the batch size is the
    # quotient degree factor, 1
    perm_challenges = [(ch.get_challenge(), ch.get_challenge()) for _ in range(nc)]
    ch.observe_cap(proof["perm_cap"])
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof["quotient_cap"])
    zeta = ch.get_extension_challenge()
    g = gl64.primitive_root_of_unity(degree_bits)
    zeta_next = gl64.mul(zeta, np.uint64(g))
    batches = [
        Batch(zeta, [(0, i) for i in range(COLUMNS)] + [(1, i) for i in range(nc)]
              + [(2, i) for i in range(nc)],
              np.concatenate([o["local"], o["perm"], o["quotient"]])),
        Batch(zeta_next, [(0, i) for i in range(COLUMNS)] + [(1, i) for i in range(nc)],
              np.concatenate([o["next"], o["perm_next"]])),
    ]
    observe_openings(ch, batches)
    chal = challenges(ch, proof["fri"], params)

    z = E2(zeta)
    one = E2.of(1)
    n = rows
    zeta_n = z.pow_const(n)
    z_h = zeta_n - one
    g_last = pow(g, P - 2, P)
    z_last = z - E2.of(g_last)
    l_first = z_h * ((z - one) * E2.of(n)).inv()
    l_last = z_h * ((z - E2.of(g_last)) * E2.of(n)).inv()
    local = [E2(v) for v in o["local"]]
    nxt = [E2(v) for v in o["next"]]
    pis = [E2.of(int(v) % P) for v in proof["public_inputs"]]
    zs = [E2(v) for v in o["perm"]]
    zs_next = [E2(v) for v in o["perm_next"]]

    constraints = [
        (local[0] - pis[0]) * l_first,
        (local[1] - pis[1]) * l_first,
        (local[1] - pis[2]) * l_last,
        (nxt[0] - local[1]) * z_last,
        (nxt[1] - local[0] - local[1]) * z_last,
    ]
    constraints += [(zj - one) * l_first for zj in zs]
    lhs, rhs = PERM_PAIR
    for j, (beta, gamma) in enumerate(perm_challenges):
        gm = E2.of(gamma)
        constraints.append(zs_next[j] * (gm + local[rhs]) - zs[j] * (gm + local[lhs]))
    for i, alpha in enumerate(alphas):
        acc = E2.of(0)
        a = E2.of(alpha)
        for c in constraints:
            acc = acc * a + c
        quotient = E2(o["quotient"][i])
        ensure(acc.equals(z_h * quotient),
               f"the constraints do not vanish at zeta (challenge {i})")
    verify_fri([COLUMNS, nc, nc], batches,
               [proof["trace_cap"], proof["perm_cap"], proof["quotient_cap"]],
               proof["fri"], chal, params)


__all__ = ["Rejected", "fib_result", "public_inputs", "verify"]
