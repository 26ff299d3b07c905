"""ArithmeticGate: num_ops slots of `c0*m0*m1 + c1*addend` per row.

Twin of reference gates/arithmetic_base.rs:26 (wires: 4 per op, 20 ops with
80 routed wires)."""

from __future__ import annotations

from .. import targets
from .base import EvalVars, Gate, GeneratorSpec


class ArithmeticGate(Gate):
    def __init__(self, num_ops: int = 20):
        self.num_ops = num_ops

    @staticmethod
    def new_from_config(config) -> "ArithmeticGate":
        return ArithmeticGate(config.num_routed_wires // 4)

    def id(self) -> str:
        return f"ArithmeticGate {{ num_ops: {self.num_ops} }}"

    @staticmethod
    def wire_ith_multiplicand_0(i):
        return 4 * i

    @staticmethod
    def wire_ith_multiplicand_1(i):
        return 4 * i + 1

    @staticmethod
    def wire_ith_addend(i):
        return 4 * i + 2

    @staticmethod
    def wire_ith_output(i):
        return 4 * i + 3

    def num_wires(self) -> int:
        return 4 * self.num_ops

    def num_constants(self) -> int:
        return 2

    def degree(self) -> int:
        return 3

    def num_constraints(self) -> int:
        return self.num_ops

    def eval_unfiltered(self, ctx, vars: EvalVars) -> list:
        c0 = vars.local_constants[0]
        c1 = vars.local_constants[1]
        out = []
        for i in range(self.num_ops):
            m0 = vars.local_wires[self.wire_ith_multiplicand_0(i)]
            m1 = vars.local_wires[self.wire_ith_multiplicand_1(i)]
            addend = vars.local_wires[self.wire_ith_addend(i)]
            output = vars.local_wires[self.wire_ith_output(i)]
            out.append(output - (m0 * m1 * c0 + addend * c1))
        return out

    def generators(self, row: int, local_constants) -> list:
        c0, c1 = int(local_constants[0]), int(local_constants[1])
        return [
            GeneratorSpec(
                kind="arithmetic",
                deps=[targets.wire(row, self.wire_ith_multiplicand_0(i)),
                      targets.wire(row, self.wire_ith_multiplicand_1(i)),
                      targets.wire(row, self.wire_ith_addend(i))],
                outs=[targets.wire(row, self.wire_ith_output(i))],
                params=(c0, c1),
            )
            for i in range(self.num_ops)
        ]
