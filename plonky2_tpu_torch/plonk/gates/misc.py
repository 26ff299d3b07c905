"""BaseSumGate, ExponentiationGate, RandomAccessGate.

Twins of reference gates/{base_sum.rs:29, exponentiation.rs:29,
random_access.rs:30}."""

from __future__ import annotations

from .. import targets
from .base import EvalVars, Gate, GeneratorSpec


class BaseSumGate(Gate):
    """sum = reduce_with_powers(limbs, B) with per-limb range checks."""

    WIRE_SUM = 0
    START_LIMBS = 1

    def __init__(self, num_limbs: int, base: int = 2):
        self.num_limbs = num_limbs
        self.base = base

    @staticmethod
    def new_from_config(config, base: int = 2):
        import math
        # log_floor(p - 1, base)
        max_limbs = 63 if base == 2 else int(
            math.log(2**64 - 2**32, base))
        return BaseSumGate(min(max_limbs, config.num_routed_wires - 1), base)

    def id(self):
        return f"BaseSumGate {{ num_limbs: {self.num_limbs} }} + Base: {self.base}"

    def limbs(self):
        return range(self.START_LIMBS, self.START_LIMBS + self.num_limbs)

    def num_wires(self):
        return 1 + self.num_limbs

    def degree(self):
        return self.base

    def num_constraints(self):
        return 1 + self.num_limbs

    def eval_unfiltered(self, ctx, vars: EvalVars):
        s = vars.local_wires[self.WIRE_SUM]
        limbs = [vars.local_wires[i] for i in self.limbs()]
        # Horner with base B
        computed = ctx.zero()
        for l in reversed(limbs):
            computed = computed * ctx.constant(self.base) + l
        constraints = [computed - s]
        for l in limbs:
            acc = None
            for i in range(self.base):
                term = l - ctx.constant(i)
                acc = term if acc is None else acc * term
            constraints.append(acc)
        return constraints

    def generators(self, row, local_constants):
        return [GeneratorSpec(
            kind="base_sum",
            deps=[targets.wire(row, self.WIRE_SUM)],
            outs=[targets.wire(row, i) for i in self.limbs()],
            params=(self.base, self.num_limbs),
        )]


class ExponentiationGate(Gate):
    """x^n via square-and-multiply over the bits of n
    (reference gates/exponentiation.rs:29)."""

    def __init__(self, num_power_bits: int):
        self.num_power_bits = num_power_bits

    @staticmethod
    def new_from_config(config):
        # max_power_bits given wire budget (exponentiation.rs:44)
        return ExponentiationGate((config.num_wires - 2) // 2)

    def id(self):
        return (f"ExponentiationGate {{ num_power_bits: {self.num_power_bits},"
                f" _phantom: PhantomData<plonky2_field::goldilocks_field::GoldilocksField> }}<D=2>")

    def wire_base(self):
        return 0

    def wire_power_bit(self, i):
        return 1 + i

    def wire_output(self):
        return 1 + self.num_power_bits

    def wire_intermediate_value(self, i):
        return 2 + self.num_power_bits + i

    def num_wires(self):
        return 2 + 2 * self.num_power_bits

    def degree(self):
        return 4

    def num_constraints(self):
        return self.num_power_bits + 1

    def eval_unfiltered(self, ctx, vars: EvalVars):
        base = vars.local_wires[self.wire_base()]
        bits = [vars.local_wires[self.wire_power_bit(i)]
                for i in range(self.num_power_bits)]
        ivs = [vars.local_wires[self.wire_intermediate_value(i)]
               for i in range(self.num_power_bits)]
        output = vars.local_wires[self.wire_output()]
        constraints = []
        for i in range(self.num_power_bits):
            prev = ctx.one() if i == 0 else ivs[i - 1] * ivs[i - 1]
            cur_bit = bits[self.num_power_bits - i - 1]
            not_bit = ctx.one() - cur_bit
            computed = prev * (cur_bit * base + not_bit)
            constraints.append(computed - ivs[i])
        constraints.append(output - ivs[self.num_power_bits - 1])
        return constraints

    def generators(self, row, local_constants):
        deps = [targets.wire(row, self.wire_base())]
        deps += [targets.wire(row, self.wire_power_bit(i))
                 for i in range(self.num_power_bits)]
        outs = [targets.wire(row, self.wire_intermediate_value(i))
                for i in range(self.num_power_bits)]
        outs.append(targets.wire(row, self.wire_output()))
        return [GeneratorSpec(kind="exponentiation", deps=deps, outs=outs,
                              params=(self.num_power_bits,))]


class RandomAccessGate(Gate):
    """Dynamic list indexing via binary-decomposed index folding
    (reference gates/random_access.rs:30)."""

    def __init__(self, bits: int, num_copies: int, num_extra_constants: int = 0):
        self.bits = bits
        self.num_copies = num_copies
        self.num_extra_constants = num_extra_constants

    @staticmethod
    def new_from_config(config, bits: int):
        vec_size = 1 << bits
        max_copies = min(config.num_routed_wires // (2 + vec_size),
                         config.num_wires // (2 + vec_size + bits))
        max_extra = config.num_routed_wires - (2 + vec_size) * max_copies
        return RandomAccessGate(bits, max_copies,
                                min(max_extra, config.num_constants))

    def id(self):
        return (f"RandomAccessGate {{ bits: {self.bits}, num_copies: "
                f"{self.num_copies}, num_extra_constants: {self.num_extra_constants},"
                f" _phantom: PhantomData<plonky2_field::goldilocks_field::GoldilocksField> }}<D=2>")

    @property
    def num_ops(self):
        return self.num_copies  # find_slot slot count

    def vec_size(self):
        return 1 << self.bits

    def wire_access_index(self, copy):
        return (2 + self.vec_size()) * copy

    def wire_claimed_element(self, copy):
        return (2 + self.vec_size()) * copy + 1

    def wire_list_item(self, i, copy):
        return (2 + self.vec_size()) * copy + 2 + i

    def start_extra_constants(self):
        return (2 + self.vec_size()) * self.num_copies

    def wire_extra_constant(self, i):
        return self.start_extra_constants() + i

    def num_routed_wires_used(self):
        return self.start_extra_constants() + self.num_extra_constants

    def wire_bit(self, i, copy):
        return self.num_routed_wires_used() + copy * self.bits + i

    def num_wires(self):
        return self.num_routed_wires_used() + self.num_copies * self.bits

    def num_constants(self):
        return self.num_extra_constants

    def degree(self):
        return self.bits + 1

    def num_constraints(self):
        return (self.bits + 2) * self.num_copies + self.num_extra_constants

    def eval_unfiltered(self, ctx, vars: EvalVars):
        constraints = []
        for copy in range(self.num_copies):
            access_index = vars.local_wires[self.wire_access_index(copy)]
            items = [vars.local_wires[self.wire_list_item(i, copy)]
                     for i in range(self.vec_size())]
            claimed = vars.local_wires[self.wire_claimed_element(copy)]
            bits = [vars.local_wires[self.wire_bit(i, copy)]
                    for i in range(self.bits)]
            for b in bits:
                constraints.append(b * (b - ctx.one()))
            recon = ctx.zero()
            for b in reversed(bits):
                recon = recon + recon + b
            constraints.append(recon - access_index)
            for b in bits:
                items = [items[2 * i] + b * (items[2 * i + 1] - items[2 * i])
                         for i in range(len(items) // 2)]
            constraints.append(items[0] - claimed)
        for i in range(self.num_extra_constants):
            constraints.append(vars.local_constants[i]
                               - vars.local_wires[self.wire_extra_constant(i)])
        return constraints

    def extra_constant_wires(self):
        return [(i, self.wire_extra_constant(i))
                for i in range(self.num_extra_constants)]

    def generators(self, row, local_constants):
        return [GeneratorSpec(
            kind="random_access_bits",
            deps=[targets.wire(row, self.wire_access_index(copy))],
            outs=[targets.wire(row, self.wire_bit(i, copy))
                  for i in range(self.bits)],
            params=(self.bits,),
        ) for copy in range(self.num_copies)]
