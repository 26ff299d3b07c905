"""Small example circuits (twins of reference plonky2/examples/*.rs):
fibonacci, factorial, range_check, and square_root (custom generator)."""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..plonk.builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..plonk.gates.base import GeneratorSpec
from ..plonk.generators import register_custom
from ..plonk.witness import PartialWitness

P = gl64.ORDER_INT


def fibonacci_circuit(n_steps: int = 100, config: CircuitConfig | None = None,
                      device=None):
    """The 100th Fibonacci number from (x0, x1) (examples/fibonacci.rs).
    Returns (data, initial_a, initial_b)."""
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    initial_a = b.add_virtual_target()
    initial_b = b.add_virtual_target()
    prev, cur = initial_a, initial_b
    for _ in range(n_steps - 1):
        prev, cur = cur, b.add(prev, cur)
    b.register_public_input(initial_a)
    b.register_public_input(initial_b)
    b.register_public_input(cur)
    return b.build(device), initial_a, initial_b


def factorial_circuit(n: int = 100, config: CircuitConfig | None = None,
                      device=None):
    """n! starting from an initial value (examples/factorial.rs).
    Returns (data, initial)."""
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    initial = b.add_virtual_target()
    cur = initial
    for i in range(2, n + 1):
        cur = b.mul_const(i, cur)
    b.register_public_input(initial)
    b.register_public_input(cur)
    return b.build(device), initial


def range_check_circuit(num_bits: int = 32,
                        config: CircuitConfig | None = None, device=None):
    """Prove a value fits in num_bits (examples/range_check.rs).
    Returns (data, value_target)."""
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    value = b.add_virtual_target()
    b.range_check(value, num_bits)
    b.register_public_input(value)
    return b.build(device), value


def square_root_circuit(config: CircuitConfig | None = None, device=None):
    """Prove knowledge of sqrt(x) with the root witnessed by a custom
    generator (examples/square_root.rs:29 SquareRootGenerator).
    Returns (data, x_target)."""
    b = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    x = b.add_virtual_target()
    sqrt = b.add_virtual_target()

    b.add_simple_generator(GeneratorSpec(
        kind="custom", deps=[x], outs=[sqrt],
        fn=_make_sqrt_generator((), None), name="square_root"))
    square = b.mul(sqrt, sqrt)
    b.connect(square, x)
    b.register_public_input(x)
    return b.build(device), x


@register_custom("square_root")
def _make_sqrt_generator(params, luts):
    """The user-registered custom generator of the square-root example
    (examples/square_root.rs:29 SquareRootGenerator + its serializer)."""
    def compute_sqrt(dep_vals: np.ndarray) -> list:
        v = int(gl64.to_canonical(np.uint64(dep_vals[0])))
        # Tonelli-Shanks via the field's 2-adic structure (p-1 = 2^32 * m)
        r = _sqrt_mod_p(v)
        assert r is not None, f"{v} is not a quadratic residue"
        return [r]
    return compute_sqrt


def _sqrt_mod_p(v: int) -> int | None:
    """Tonelli-Shanks for p = 2^64 - 2^32 + 1 (2-adicity 32)."""
    if v == 0:
        return 0
    if pow(v, (P - 1) // 2, P) != 1:
        return None
    m = (P - 1) >> 32
    c = pow(gl64.MULTIPLICATIVE_GROUP_GENERATOR, m, P)  # order-2^32 generator
    t = pow(v, m, P)
    r = pow(v, (m + 1) // 2, P)
    big_m = 32
    while t != 1:
        # find least i with t^(2^i) = 1
        i, t2 = 0, t
        while t2 != 1:
            t2 = (t2 * t2) % P
            i += 1
        b = pow(c, 1 << (big_m - i - 1), P)
        r = (r * b) % P
        c = (b * b) % P
        t = (t * c) % P
        big_m = i
    return r


def prove_fibonacci(n_steps: int = 100, x0: int = 0, x1: int = 1,
                    config: CircuitConfig | None = None, device=None):
    data, ta, tb = fibonacci_circuit(n_steps, config, device)
    pw = PartialWitness()
    pw.set_target(ta, x0)
    pw.set_target(tb, x1)
    proof = data.prove(pw)
    data.verify(proof)
    return data, proof
