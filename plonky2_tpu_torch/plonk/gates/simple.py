"""ConstantGate, PublicInputGate, NoopGate (twins of reference
gates/{constant.rs:24, public_input.rs:21, noop.rs:14})."""

from __future__ import annotations

from .. import targets
from .base import EvalVars, Gate, GeneratorSpec


class ConstantGate(Gate):
    """Routes num_consts constants into routable wires."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def id(self) -> str:
        return f"ConstantGate {{ num_consts: {self.num_consts} }}"

    def num_wires(self) -> int:
        return self.num_consts

    def num_constants(self) -> int:
        return self.num_consts

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return self.num_consts

    def eval_unfiltered(self, ctx, vars: EvalVars) -> list:
        return [vars.local_constants[i] - vars.local_wires[i]
                for i in range(self.num_consts)]

    def extra_constant_wires(self) -> list:
        return [(i, i) for i in range(self.num_consts)]


class PublicInputGate(Gate):
    """Pins wires 0..4 to the public-input hash."""

    def id(self) -> str:
        return "PublicInputGate"

    def num_wires(self) -> int:
        return 4

    def degree(self) -> int:
        return 1

    def num_constraints(self) -> int:
        return 4

    def eval_unfiltered(self, ctx, vars: EvalVars) -> list:
        return [vars.local_wires[i] - vars.public_inputs_hash[i] for i in range(4)]


class NoopGate(Gate):
    def id(self) -> str:
        return "NoopGate"

    def num_wires(self) -> int:
        return 0

    def degree(self) -> int:
        return 0

    def num_constraints(self) -> int:
        return 0

    def eval_unfiltered(self, ctx, vars: EvalVars) -> list:
        return []
