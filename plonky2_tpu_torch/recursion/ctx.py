"""Circuit evaluation context: gate constraints as in-circuit algebra.

The third instantiation of the field-polymorphic gate framework
(plonk/gates/base.py): elements wrap D=2 extension targets and every
arithmetic op appends extension-gate slots to the builder.  Reusing each
gate's `eval_unfiltered` this way is the twin of the reference's per-gate
`eval_unfiltered_circuit` implementations (gates/gate.rs:96) without
hand-writing a circuit evaluator per gate.  Host only: it never touches a
device.
"""

from __future__ import annotations

from ..plonk import targets as tg
from ..plonk.gates.ext_gates import PoseidonMdsGate


class CtE:
    """One extension element in the circuit: a (t0, t1) ext-target pair."""

    __slots__ = ("ctx", "t")

    def __init__(self, ctx, t):
        self.ctx = ctx
        self.t = t

    def __add__(self, o):
        return CtE(self.ctx, self.ctx.b.add_extension(self.t, o.t))

    def __sub__(self, o):
        return CtE(self.ctx, self.ctx.b.sub_extension(self.t, o.t))

    def __mul__(self, o):
        return CtE(self.ctx, self.ctx.b.mul_extension(self.t, o.t))

    def mul_small(self, c: int):
        return CtE(self.ctx, self.ctx.b.mul_const_extension(c, self.t))


class CircuitCtx:
    """Evaluation context whose elements build circuit constraints."""

    ext = True
    # evaluations build gates here, so shortcuts that leave a value-ctx's
    # result unchanged would change the circuit (stark/ctl.py Column.eval)
    builds_circuit = True

    def __init__(self, builder):
        self.b = builder

    def wrap(self, ext_target: tuple) -> CtE:
        return CtE(self, ext_target)

    def wrap_base(self, base_target: int) -> CtE:
        return CtE(self, self.b.convert_to_ext(base_target))

    def constant(self, v: int) -> CtE:
        return CtE(self, self.b.constant_extension(int(v)))

    def zero(self) -> CtE:
        return self.constant(0)

    def one(self) -> CtE:
        return self.constant(1)

    def poseidon_mds_layer(self, state: list) -> list:
        """Full-round MDS over 12 extension elements as one PoseidonMdsGate
        row (reference hash/poseidon.rs:284-300)."""
        b = self.b
        gate = PoseidonMdsGate()
        row = b.add_gate(gate, [])
        for i, s in enumerate(state):
            w = gate.wires_input(i)
            b.connect_extension(s.t, (tg.wire(row, w), tg.wire(row, w + 1)))
        out = []
        for i in range(gate.WIDTH):
            w = gate.wires_output(i)
            out.append(CtE(self, (tg.wire(row, w), tg.wire(row, w + 1))))
        return out
