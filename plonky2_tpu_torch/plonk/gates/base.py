"""Gate framework: constraint-evaluation contexts, generator specs, Gate.

Twin of reference gates/gate.rs:28.  AIR and gate code is written once
against operator-overloaded field elements plus a small ``ctx`` factory; the
same code runs in the prover's quotient pass (torch GF arrays over all coset
points at once) and in the verifier (host E2 extension scalars).

Witness generation is declared as ``GeneratorSpec``s: static (deps, outs)
target lists plus a vectorisable kind, so the witness engine can level the
dataflow at build time and execute whole levels as batched numpy (replacing
the reference's dynamic watch-list scheduler, iop/generator.rs:54).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ...field import gl64ext
from ...field.goldilocks import GF, scalar


class BaseBatchCtx:
    """Prover context: elements are GF arrays broadcast over coset points."""

    ext = False

    def __init__(self, device):
        self.device = device

    def constant(self, v: int):
        return GF(scalar(v, self.device))

    def zero(self):
        return GF(scalar(0, self.device))

    def one(self):
        return GF(scalar(1, self.device))


class ExtCtx:
    """Verifier context: elements are host E2 extension scalars."""

    ext = True

    def constant(self, v: int):
        return gl64ext.E2.from_base_int(v)

    def zero(self):
        return gl64ext.E2.of(0)

    def one(self):
        return gl64ext.E2.of(1)


@dataclass
class EvalVars:
    """Per-point view for gate evaluation (reference plonk/vars.rs:12).
    `local_constants` has the selector prefix already removed."""

    local_constants: list
    local_wires: list
    public_inputs_hash: list  # 4 elements


@dataclass
class GeneratorSpec:
    """A witness generator with a static dependency signature.

    kinds: 'arithmetic' (params=(c0, c1), deps=[m0, m1, addend], outs=[out]),
    'poseidon' (deps=[12 inputs, swap], outs=gate trace wires), 'constant'
    (params=(value,)), 'random', 'copy' (deps=[src], outs=[dst]), 'custom'
    (fn: np dep values -> np out values).
    """

    kind: str
    deps: list
    outs: list
    params: tuple = ()
    fn: Callable | None = None
    # registry name for kind="custom" (plonk/generators.py) — lets the
    # schedule serializer rebuild `fn`; None means not checkpointable
    name: str | None = None


class Gate:
    """Base class; mirrors the reference Gate trait surface we need."""

    def id(self) -> str:
        raise NotImplementedError

    def num_wires(self) -> int:
        raise NotImplementedError

    def num_constants(self) -> int:
        return 0

    def degree(self) -> int:
        raise NotImplementedError

    def num_constraints(self) -> int:
        raise NotImplementedError

    def eval_unfiltered(self, ctx, vars: EvalVars) -> list:
        raise NotImplementedError

    def generators(self, row: int, local_constants) -> list:
        return []

    def extra_constant_wires(self) -> list:
        """(constant_index, wire_index) pairs, for ConstantGate routing."""
        return []

    # identity/ordering helpers
    def __eq__(self, other):
        return type(self) is type(other) and self.id() == other.id()

    def __hash__(self):
        return hash(self.id())
