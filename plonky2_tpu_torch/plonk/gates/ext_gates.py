"""Extension-field gates: arithmetic/mul over GF(p^2) wires, alpha-folding
(Reducing) gates, and the Poseidon MDS gate.

Twins of reference gates/{arithmetic_extension.rs:22, multiplication_extension.rs:22,
reducing.rs:20, reducing_extension.rs:20, poseidon_mds.rs:24}.

Extension wires occupy D=2 consecutive wire slots.  When constraints are
evaluated at a point of GF(p^2) itself, wire pairs form the *extension
algebra* GF(p^2)[X]/(X^2-7) over the evaluation field — `ExtAlg` implements
that algebra generically over the evaluation context (reference
field/src/extension/algebra.rs:11)."""

from __future__ import annotations

from ...hash import poseidon_constants as C
from .. import targets
from .base import EvalVars, Gate, GeneratorSpec

W = 7
D = 2


class ExtAlg:
    """(a0, a1) representing a0 + a1*X over the evaluation field, X^2 = W."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def from_base(x, ctx):
        return ExtAlg(x, ctx.zero())

    def __add__(self, o):
        return ExtAlg(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return ExtAlg(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        a0b0 = self.c0 * o.c0
        a1b1 = self.c1 * o.c1
        a0b1 = self.c0 * o.c1
        a1b0 = self.c1 * o.c0
        return ExtAlg(a0b0 + a1b1.mul_small(W), a0b1 + a1b0)

    def scalar_mul(self, s):
        return ExtAlg(self.c0 * s, self.c1 * s)

    def components(self):
        return [self.c0, self.c1]


def _get_alg(vars: EvalVars, start: int) -> ExtAlg:
    return ExtAlg(vars.local_wires[start], vars.local_wires[start + 1])


class ArithmeticExtensionGate(Gate):
    """num_ops slots of c0*m0*m1 + c1*addend over GF(p^2) (8 wires/op)."""

    def __init__(self, num_ops: int = 10):
        self.num_ops = num_ops

    @staticmethod
    def new_from_config(config):
        return ArithmeticExtensionGate(config.num_routed_wires // (4 * D))

    def id(self):
        return f"ArithmeticExtensionGate {{ num_ops: {self.num_ops} }}"

    @staticmethod
    def wires_ith_multiplicand_0(i):
        return 4 * D * i

    @staticmethod
    def wires_ith_multiplicand_1(i):
        return 4 * D * i + D

    @staticmethod
    def wires_ith_addend(i):
        return 4 * D * i + 2 * D

    @staticmethod
    def wires_ith_output(i):
        return 4 * D * i + 3 * D

    def num_wires(self):
        return 4 * D * self.num_ops

    def num_constants(self):
        return 2

    def degree(self):
        return 3

    def num_constraints(self):
        return D * self.num_ops

    def eval_unfiltered(self, ctx, vars: EvalVars):
        c0 = vars.local_constants[0]
        c1 = vars.local_constants[1]
        out = []
        for i in range(self.num_ops):
            m0 = _get_alg(vars, self.wires_ith_multiplicand_0(i))
            m1 = _get_alg(vars, self.wires_ith_multiplicand_1(i))
            ad = _get_alg(vars, self.wires_ith_addend(i))
            o = _get_alg(vars, self.wires_ith_output(i))
            computed = (m0 * m1).scalar_mul(c0) + ad.scalar_mul(c1)
            out.extend((o - computed).components())
        return out

    def generators(self, row, local_constants):
        c0, c1 = int(local_constants[0]), int(local_constants[1])
        return [GeneratorSpec(
            kind="arith_ext",
            deps=[targets.wire(row, self.wires_ith_multiplicand_0(i) + j) for j in range(D)]
            + [targets.wire(row, self.wires_ith_multiplicand_1(i) + j) for j in range(D)]
            + [targets.wire(row, self.wires_ith_addend(i) + j) for j in range(D)],
            outs=[targets.wire(row, self.wires_ith_output(i) + j) for j in range(D)],
            params=(c0, c1),
        ) for i in range(self.num_ops)]


class MulExtensionGate(Gate):
    """num_ops slots of c0*m0*m1 over GF(p^2) (6 wires/op)."""

    def __init__(self, num_ops: int = 13):
        self.num_ops = num_ops

    @staticmethod
    def new_from_config(config):
        return MulExtensionGate(config.num_routed_wires // (3 * D))

    def id(self):
        return f"MulExtensionGate {{ num_ops: {self.num_ops} }}"

    @staticmethod
    def wires_ith_multiplicand_0(i):
        return 3 * D * i

    @staticmethod
    def wires_ith_multiplicand_1(i):
        return 3 * D * i + D

    @staticmethod
    def wires_ith_output(i):
        return 3 * D * i + 2 * D

    def num_wires(self):
        return 3 * D * self.num_ops

    def num_constants(self):
        return 1

    def degree(self):
        return 3

    def num_constraints(self):
        return D * self.num_ops

    def eval_unfiltered(self, ctx, vars: EvalVars):
        c0 = vars.local_constants[0]
        out = []
        for i in range(self.num_ops):
            m0 = _get_alg(vars, self.wires_ith_multiplicand_0(i))
            m1 = _get_alg(vars, self.wires_ith_multiplicand_1(i))
            o = _get_alg(vars, self.wires_ith_output(i))
            out.extend((o - (m0 * m1).scalar_mul(c0)).components())
        return out

    def generators(self, row, local_constants):
        c0 = int(local_constants[0])
        return [GeneratorSpec(
            kind="mul_ext",
            deps=[targets.wire(row, self.wires_ith_multiplicand_0(i) + j) for j in range(D)]
            + [targets.wire(row, self.wires_ith_multiplicand_1(i) + j) for j in range(D)],
            outs=[targets.wire(row, self.wires_ith_output(i) + j) for j in range(D)],
            params=(c0,),
        ) for i in range(self.num_ops)]


class ReducingGate(Gate):
    """Horner steps acc' = acc*alpha + coeff for BASE-field coeffs
    (reference gates/reducing.rs:20).  num_coeffs base coeff wires."""

    def __init__(self, num_coeffs: int):
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires):
        return min((num_wires - 3 * D) // (D + 1), num_routed_wires - 3 * D)

    def id(self):
        return f"ReducingGate {{ num_coeffs: {self.num_coeffs} }}"

    @staticmethod
    def wires_output():
        return 0

    @staticmethod
    def wires_alpha():
        return D

    @staticmethod
    def wires_old_acc():
        return 2 * D

    START_COEFFS = 3 * D

    def wire_coeff(self, i):
        return self.START_COEFFS + i

    def start_accs(self):
        return self.START_COEFFS + self.num_coeffs

    def wires_accs(self, i):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        return self.start_accs() + D * i

    def num_wires(self):
        return self.start_accs() + D * (self.num_coeffs - 1)

    def degree(self):
        return 2

    def num_constraints(self):
        return D * self.num_coeffs

    def eval_unfiltered(self, ctx, vars: EvalVars):
        alpha = _get_alg(vars, self.wires_alpha())
        acc = _get_alg(vars, self.wires_old_acc())
        out = []
        for i in range(self.num_coeffs):
            coeff = ExtAlg.from_base(vars.local_wires[self.wire_coeff(i)], ctx)
            acc_next = _get_alg(vars, self.wires_accs(i))
            out.extend((acc * alpha + coeff - acc_next).components())
            acc = acc_next
        return out

    def generators(self, row, local_constants):
        deps = [targets.wire(row, self.wires_alpha() + j) for j in range(D)]
        deps += [targets.wire(row, self.wires_old_acc() + j) for j in range(D)]
        deps += [targets.wire(row, self.wire_coeff(i)) for i in range(self.num_coeffs)]
        outs = []
        for i in range(self.num_coeffs):
            outs += [targets.wire(row, self.wires_accs(i) + j) for j in range(D)]
        return [GeneratorSpec(kind="reducing", deps=deps, outs=outs,
                              params=(self.num_coeffs, False))]


class ReducingExtensionGate(Gate):
    """Horner steps with EXTENSION coeffs (reference reducing_extension.rs:20)."""

    def __init__(self, num_coeffs: int):
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires):
        return min((num_wires - 3 * D) // (2 * D), (num_routed_wires - 3 * D) // D)

    def id(self):
        return f"ReducingExtensionGate {{ num_coeffs: {self.num_coeffs} }}"

    wires_output = staticmethod(lambda: 0)
    wires_alpha = staticmethod(lambda: D)
    wires_old_acc = staticmethod(lambda: 2 * D)
    START_COEFFS = 3 * D

    def wires_coeff(self, i):
        return self.START_COEFFS + i * D

    def start_accs(self):
        return self.START_COEFFS + self.num_coeffs * D

    def wires_accs(self, i):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        return self.start_accs() + D * i

    def num_wires(self):
        return self.start_accs() + D * (self.num_coeffs - 1)

    def degree(self):
        return 2

    def num_constraints(self):
        return D * self.num_coeffs

    def eval_unfiltered(self, ctx, vars: EvalVars):
        alpha = _get_alg(vars, self.wires_alpha())
        acc = _get_alg(vars, self.wires_old_acc())
        out = []
        for i in range(self.num_coeffs):
            coeff = _get_alg(vars, self.wires_coeff(i))
            acc_next = _get_alg(vars, self.wires_accs(i))
            out.extend((acc * alpha + coeff - acc_next).components())
            acc = acc_next
        return out

    def generators(self, row, local_constants):
        deps = [targets.wire(row, self.wires_alpha() + j) for j in range(D)]
        deps += [targets.wire(row, self.wires_old_acc() + j) for j in range(D)]
        for i in range(self.num_coeffs):
            deps += [targets.wire(row, self.wires_coeff(i) + j) for j in range(D)]
        outs = []
        for i in range(self.num_coeffs):
            outs += [targets.wire(row, self.wires_accs(i) + j) for j in range(D)]
        return [GeneratorSpec(kind="reducing", deps=deps, outs=outs,
                              params=(self.num_coeffs, True))]


class PoseidonMdsGate(Gate):
    """One Poseidon MDS layer over 12 extension inputs (48 wires)
    (reference gates/poseidon_mds.rs:24)."""

    WIDTH = 12

    def id(self):
        return "PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH=12>"

    @classmethod
    def wires_input(cls, i):
        return D * i

    @classmethod
    def wires_output(cls, i):
        return D * (cls.WIDTH + i)

    def num_wires(self):
        return 2 * D * self.WIDTH

    def degree(self):
        return 2

    def num_constraints(self):
        return D * self.WIDTH

    def _mds_row(self, ctx, state, r):
        acc = None
        for i in range(self.WIDTH):
            term = state[(i + r) % self.WIDTH].scalar_mul(
                ctx.constant(C.MDS_MATRIX_CIRC[i]))
            acc = term if acc is None else acc + term
        if C.MDS_MATRIX_DIAG[r]:
            acc = acc + state[r].scalar_mul(ctx.constant(C.MDS_MATRIX_DIAG[r]))
        return acc

    def eval_unfiltered(self, ctx, vars: EvalVars):
        state = [_get_alg(vars, self.wires_input(i)) for i in range(self.WIDTH)]
        out = []
        for r in range(self.WIDTH):
            computed = self._mds_row(ctx, state, r)
            actual = _get_alg(vars, self.wires_output(r))
            out.extend((actual - computed).components())
        return out

    def generators(self, row, local_constants):
        deps = [targets.wire(row, self.wires_input(i) + j)
                for i in range(self.WIDTH) for j in range(D)]
        outs = [targets.wire(row, self.wires_output(i) + j)
                for i in range(self.WIDTH) for j in range(D)]
        return [GeneratorSpec(kind="poseidon_mds", deps=deps, outs=outs)]
