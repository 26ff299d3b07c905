"""Matrix-multiplication demo circuit: "I know A * B = C".

Twin of reference plonky2/src/bin/matrix_mul.rs:17-60 (and the m=64 variant
in plonky2/examples/matrix_multiplication.rs): m x m virtual targets for A
and B, mul/add chains for C, 3*m^2 public inputs, standard_recursion_config.
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..plonk.builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..plonk.witness import PartialWitness


def build_matrix_mul_circuit(m: int, config: CircuitConfig | None = None,
                             device=None):
    """Returns (circuit_data, a_targets, b_targets); the circuit is
    committed on ``device`` (None means CUDA)."""
    builder = CircuitBuilder(config or CircuitConfig.standard_recursion_config())
    a = [[builder.add_virtual_target() for _ in range(m)] for _ in range(m)]
    b = [[builder.add_virtual_target() for _ in range(m)] for _ in range(m)]
    c = []
    for i in range(m):
        row = []
        for j in range(m):
            current = builder.constant(0)
            for k in range(m):
                cijk = builder.mul(a[i][k], b[k][j])
                current = builder.add(current, cijk)
            row.append(current)
        c.append(row)
    for i in range(m):
        for j in range(m):
            builder.register_public_input(a[i][j])
            builder.register_public_input(b[i][j])
            builder.register_public_input(c[i][j])
    data = builder.build(device)
    return data, a, b


def matrix_mul_witness(a_targets, b_targets, a_vals: np.ndarray,
                       b_vals: np.ndarray) -> PartialWitness:
    m = len(a_targets)
    pw = PartialWitness()
    for i in range(m):
        for j in range(m):
            pw.set_target(a_targets[i][j], int(a_vals[i][j]) % gl64.ORDER_INT)
            pw.set_target(b_targets[i][j], int(b_vals[i][j]) % gl64.ORDER_INT)
    return pw


def expected_product(a_vals: np.ndarray, b_vals: np.ndarray) -> np.ndarray:
    m = a_vals.shape[0]
    out = np.zeros((m, m), dtype=np.uint64)
    for i in range(m):
        for j in range(m):
            acc = 0
            for k in range(m):
                acc = (acc + int(a_vals[i][k]) * int(b_vals[k][j])) % gl64.ORDER_INT
            out[i][j] = acc
    return out
