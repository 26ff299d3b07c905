"""Builder gadget surface (twins of reference plonky2/src/gadgets/*.rs).

ExtensionTargets (D=2) are (t0, t1) tuples of base targets; extension
arithmetic packs into ArithmeticExtensionGate / MulExtensionGate slots the
same way base arithmetic packs into ArithmeticGate (gadgets/arithmetic_extension.rs:19).
"""

from __future__ import annotations

from ..field import gl64
from . import targets as tg
from .gates.base import GeneratorSpec
from .gates.ext_gates import (ArithmeticExtensionGate, MulExtensionGate,
                              ReducingExtensionGate, ReducingGate)
from .gates.misc import BaseSumGate, ExponentiationGate, RandomAccessGate

P = gl64.ORDER_INT
D = 2


class BuilderGadgets:
    """Mixin for CircuitBuilder; relies on add_gate/find_slot/connect/
    constant/arithmetic/add_simple_generator from the core builder."""

    # -- extension targets ---------------------------------------------------
    def constant_extension(self, a: int, b: int = 0) -> tuple:
        return (self.constant(a), self.constant(b))

    def zero_extension(self) -> tuple:
        return self.constant_extension(0)

    def one_extension(self) -> tuple:
        return self.constant_extension(1)

    def convert_to_ext(self, t: int) -> tuple:
        return (t, self.zero())

    def add_virtual_extension_target(self) -> tuple:
        return (self.add_virtual_target(), self.add_virtual_target())

    def add_virtual_extension_targets(self, n: int) -> list:
        return [self.add_virtual_extension_target() for _ in range(n)]

    def connect_extension(self, x: tuple, y: tuple) -> None:
        self.connect(x[0], y[0])
        self.connect(x[1], y[1])

    def arithmetic_extension(self, const_0: int, const_1: int, m0: tuple,
                             m1: tuple, addend: tuple) -> tuple:
        """const_0 * m0 * m1 + const_1 * addend over GF(p^2)."""
        const_0 %= P
        const_1 %= P
        gate = ArithmeticExtensionGate.new_from_config(self.config)
        row, i = self.find_slot(gate, ("ext", const_0, const_1),
                                [const_0, const_1])
        w = gate.wires_ith_multiplicand_0(i)
        self.connect_extension(m0, (tg.wire(row, w), tg.wire(row, w + 1)))
        w = gate.wires_ith_multiplicand_1(i)
        self.connect_extension(m1, (tg.wire(row, w), tg.wire(row, w + 1)))
        w = gate.wires_ith_addend(i)
        self.connect_extension(addend, (tg.wire(row, w), tg.wire(row, w + 1)))
        w = gate.wires_ith_output(i)
        return (tg.wire(row, w), tg.wire(row, w + 1))

    def add_extension(self, a: tuple, b: tuple) -> tuple:
        return self.arithmetic_extension(1, 1, a, self.one_extension(), b)

    def sub_extension(self, a: tuple, b: tuple) -> tuple:
        return self.arithmetic_extension(1, P - 1, a, self.one_extension(), b)

    def mul_extension(self, a: tuple, b: tuple) -> tuple:
        gate = MulExtensionGate.new_from_config(self.config)
        row, i = self.find_slot(gate, ("mulext", 1), [1])
        w = gate.wires_ith_multiplicand_0(i)
        self.connect_extension(a, (tg.wire(row, w), tg.wire(row, w + 1)))
        w = gate.wires_ith_multiplicand_1(i)
        self.connect_extension(b, (tg.wire(row, w), tg.wire(row, w + 1)))
        w = gate.wires_ith_output(i)
        return (tg.wire(row, w), tg.wire(row, w + 1))

    def mul_add_extension(self, a: tuple, b: tuple, c: tuple) -> tuple:
        return self.arithmetic_extension(1, 1, a, b, c)

    def mul_sub_extension(self, a: tuple, b: tuple, c: tuple) -> tuple:
        return self.arithmetic_extension(1, P - 1, a, b, c)

    def mul_const_extension(self, c: int, a: tuple) -> tuple:
        return self.arithmetic_extension(c, 0, a, self.one_extension(), a)

    def mul_const_add_extension(self, c: int, a: tuple, b: tuple) -> tuple:
        return self.arithmetic_extension(c, 1, a, self.one_extension(), b)

    def scalar_mul_ext(self, s: int_or_target, a: tuple) -> tuple:
        """s (base target) * a (ext target)."""
        return self.mul_extension(self.convert_to_ext(s), a)

    def mul_many_extension(self, terms) -> tuple:
        terms = list(terms)
        acc = terms[0]
        for t in terms[1:]:
            acc = self.mul_extension(acc, t)
        return acc

    def exp_u64_extension(self, a: tuple, exp: int) -> tuple:
        if exp == 0:
            return self.one_extension()
        result = None
        cur = a
        e = exp
        while e:
            if e & 1:
                result = cur if result is None else self.mul_extension(result, cur)
            e >>= 1
            if e:
                cur = self.mul_extension(cur, cur)
        return result

    def inverse_extension(self, a: tuple) -> tuple:
        """Witness the inverse and constrain a * a_inv == 1
        (gadgets/arithmetic_extension.rs inverse_extension)."""
        inv = self.add_virtual_extension_target()

        from .generators import build_custom_fn
        self.add_simple_generator(GeneratorSpec(
            kind="custom", deps=[a[0], a[1]], outs=[inv[0], inv[1]],
            fn=build_custom_fn("inv_ext", (), None), name="inv_ext"))
        prod = self.mul_extension(a, inv)
        self.connect_extension(prod, self.one_extension())
        return inv

    def div_extension(self, a: tuple, b: tuple) -> tuple:
        return self.mul_extension(a, self.inverse_extension(b))

    # -- bit splitting / range checks (gadgets/split_join.rs:19) -------------
    def split_le(self, x: int, num_bits: int) -> list:
        """Little-endian bit decomposition via BaseSumGate<2>."""
        gate = BaseSumGate(num_bits, base=2)
        row = self.add_gate(gate, [])
        self.connect(x, tg.wire(row, gate.WIRE_SUM))
        return [tg.wire(row, i) for i in gate.limbs()]

    def le_sum(self, bits: list) -> int:
        """Recombine little-endian bits (gadgets/split_base.rs:37)."""
        num_bits = len(bits)
        if num_bits == 0:
            return self.zero()
        # cheap path: fold with mul_add when it fits one arithmetic gate
        if num_bits - 1 <= self.config.num_routed_wires // 4:
            two = self.two()
            s = bits[-1]
            for b in reversed(bits[:-1]):
                s = self.mul_add(two, s, b)
            return s
        gate = BaseSumGate.new_from_config(self.config, base=2)
        row = self.add_gate(gate, [])
        for i, b in zip(gate.limbs(), bits):
            self.connect(b, tg.wire(row, i))
        for i in list(gate.limbs())[num_bits:]:
            self.assert_zero(tg.wire(row, i))
        # The gate's own generator computes limbs FROM the sum; here the bits
        # are the inputs, so suppress it and compute the sum instead
        # (reference adds BaseSumGenerator; our static schedule must not see
        # the circular pair).
        self.suppressed_gate_generators.add(row)
        sum_wire = tg.wire(row, gate.WIRE_SUM)

        from .generators import build_custom_fn
        self.add_simple_generator(GeneratorSpec(
            kind="custom", deps=list(bits), outs=[sum_wire],
            fn=build_custom_fn("le_sum", (), None), name="le_sum"))
        return sum_wire

    def range_check(self, x: int, num_bits: int) -> None:
        self.split_le(x, num_bits)

    def assert_bool(self, b: int) -> None:
        """b * b == b (gadgets/range_check.rs assert_bool)."""
        prod = self.mul(b, b)
        self.connect(prod, b)

    # -- select (gadgets/select.rs:33) --------------------------------------
    def select(self, b: int, x: int, y: int) -> int:
        """if b { x } else { y } = b*(x-y) + y = b*x - b*y + y."""
        tmp = self.arithmetic(1, 1, b, x, y)  # b*x + y
        return self.arithmetic(P - 1, 1, b, y, tmp)  # -b*y + (b*x + y)

    # -- random access (gadgets/random_access.rs:14) --------------------------
    def random_access(self, access_index: int, v: list) -> int:
        """v[access_index] via RandomAccessGate."""
        vec_size = len(v)
        bits = max((vec_size - 1).bit_length(), 1)
        padded = list(v) + [v[-1]] * ((1 << bits) - vec_size)
        claimed = self.add_virtual_target()
        gate = RandomAccessGate.new_from_config(self.config, bits)
        row, copy = self.find_slot(gate, ("ra", bits), [])
        self.connect(access_index, tg.wire(row, gate.wire_access_index(copy)))
        self.connect(claimed, tg.wire(row, gate.wire_claimed_element(copy)))
        for i, item in enumerate(padded):
            self.connect(item, tg.wire(row, gate.wire_list_item(i, copy)))

        from .generators import build_custom_fn
        self.add_simple_generator(GeneratorSpec(
            kind="custom", deps=[access_index] + padded, outs=[claimed],
            fn=build_custom_fn("random_access_value", (), None),
            name="random_access_value"))
        return claimed

    def random_access_extension(self, access_index: int, v: list) -> tuple:
        c0 = self.random_access(access_index, [e[0] for e in v])
        c1 = self.random_access(access_index, [e[1] for e in v])
        return (c0, c1)

    # -- exponentiation (gadgets/arithmetic.rs exp_from_bits) ----------------
    def exp_from_bits(self, base: int, bits: list) -> int:
        gate = ExponentiationGate(len(bits))
        row = self.add_gate(gate, [])
        self.connect(base, tg.wire(row, gate.wire_base()))
        for i, b in enumerate(bits):
            self.connect(b, tg.wire(row, gate.wire_power_bit(i)))
        return tg.wire(row, gate.wire_output())

    def exp_u64(self, base: int, exponent: int) -> int:
        nbits = max(exponent.bit_length(), 1)
        bits = [self.constant((exponent >> i) & 1) for i in range(nbits)]
        return self.exp_from_bits(base, bits)

    def exp_power_of_2(self, base: int, log_exp: int) -> int:
        cur = base
        for _ in range(log_exp):
            cur = self.square(cur)
        return cur

    def exp_from_bits_const_base(self, base: int, bits_le: list) -> int:
        """base^(sum 2^i b_i) for a CONSTANT integer base and bit targets
        (gadgets/arithmetic.rs:273): product *= 1 + b*(base^{2^i} - 1)."""
        product = self.one()
        for i, b in enumerate(bits_le):
            pw = gl64.pow_scalar(base, 1 << i)
            product = self.arithmetic((pw - 1) % P, 1, product, b, product)
        return product

    # -- extension helpers for the recursive verifier -------------------------
    def square_extension(self, a: tuple) -> tuple:
        return self.mul_extension(a, a)

    def exp_power_of_2_extension(self, a: tuple, log_exp: int) -> tuple:
        cur = a
        for _ in range(log_exp):
            cur = self.square_extension(cur)
        return cur

    def select_ext(self, b: int, x: tuple, y: tuple) -> tuple:
        return (self.select(b, x[0], y[0]), self.select(b, x[1], y[1]))

    # -- bit helpers (gadgets/range_check.rs:19) ------------------------------
    def low_bits(self, x: int, num_low_bits: int, num_bits: int = 64) -> list:
        return self.split_le(x, num_bits)[:num_low_bits]

    def assert_leading_zeros(self, x: int, leading_zeros: int) -> None:
        """Assert the top `leading_zeros` bits of x (as a 64-bit value) are 0."""
        self.range_check(x, 64 - leading_zeros)

    # -- in-circuit hashing (hash/hashing.rs:15, merkle_proofs.rs:114) --------
    def hash_or_noop(self, inputs: list) -> list:
        if len(inputs) <= 4:
            zero = self.zero()
            return list(inputs) + [zero] * (4 - len(inputs))
        return self.hash_n_to_hash_no_pad(inputs)

    def verify_merkle_proof_to_cap_with_cap_index(
            self, leaf_data: list, leaf_index_bits: list, cap_index: int,
            merkle_cap: list, proof_siblings: list) -> None:
        """Walk leaf->cap with swap bits, then pin against cap[cap_index]
        (reference hash/merkle_proofs.rs:114)."""
        zero = self.zero()
        state = self.hash_or_noop(leaf_data)
        for bit, sibling in zip(leaf_index_bits, proof_siblings):
            perm_in = state + list(sibling) + [zero] * 4
            out = self.permute_swapped(perm_in, bit)
            state = out[:4]
        for i in range(4):
            got = self.random_access(cap_index, [h[i] for h in merkle_cap])
            self.connect(got, state[i])

    def connect_hashes(self, x: list, y: list) -> None:
        for a, b in zip(x, y):
            self.connect(a, b)


class ReducingFactorTarget:
    """alpha-power folding over targets (twin of util/reducing.rs:114).

    reduce(terms) = sum_i terms[i] * alpha^i via ReducingGate /
    ReducingExtensionGate packing; shift(x) = x * alpha^count where count
    accumulates the lengths of prior reduce calls."""

    def __init__(self, base_ext: tuple):
        self.base = base_ext
        self.count = 0

    def reduce_base(self, terms: list, b) -> tuple:
        """terms: base-field targets."""
        num_arith_ops = b.config.num_routed_wires // (4 * D)
        if len(terms) <= num_arith_ops + 1:
            return self._reduce_arithmetic([b.convert_to_ext(t) for t in terms], b)
        max_len = ReducingGate.max_coeffs_len(b.config.num_wires,
                                              b.config.num_routed_wires)
        self.count += len(terms)
        zero = b.zero()
        acc = b.zero_extension()
        rev = list(terms)
        while len(rev) % max_len:
            rev.append(zero)
        rev.reverse()
        for start in range(0, len(rev), max_len):
            chunk = rev[start:start + max_len]
            gate = ReducingGate(max_len)
            row = b.add_gate(gate, [])
            b.connect_extension(self.base, _ext_wires(row, gate.wires_alpha()))
            b.connect_extension(acc, _ext_wires(row, gate.wires_old_acc()))
            for i, t in enumerate(chunk):
                b.connect(t, tg.wire(row, gate.wire_coeff(i)))
            acc = _ext_wires(row, gate.wires_output())
        return acc

    def reduce(self, terms: list, b) -> tuple:
        """terms: extension targets."""
        num_arith_ops = b.config.num_routed_wires // (4 * D)
        if len(terms) <= num_arith_ops + 1:
            return self._reduce_arithmetic(list(terms), b)
        max_len = ReducingExtensionGate.max_coeffs_len(b.config.num_wires,
                                                       b.config.num_routed_wires)
        self.count += len(terms)
        zero_ext = b.zero_extension()
        acc = b.zero_extension()
        rev = list(terms)
        while len(rev) % max_len:
            rev.append(zero_ext)
        rev.reverse()
        for start in range(0, len(rev), max_len):
            chunk = rev[start:start + max_len]
            gate = ReducingExtensionGate(max_len)
            row = b.add_gate(gate, [])
            b.connect_extension(self.base, _ext_wires(row, gate.wires_alpha()))
            b.connect_extension(acc, _ext_wires(row, gate.wires_old_acc()))
            for i, t in enumerate(chunk):
                b.connect_extension(t, _ext_wires(row, gate.wires_coeff(i)))
            acc = _ext_wires(row, gate.wires_output())
        return acc

    def _reduce_arithmetic(self, terms: list, b) -> tuple:
        self.count += len(terms)
        acc = b.zero_extension()
        for t in reversed(terms):
            acc = b.mul_add_extension(acc, self.base, t)
        return acc

    def shift(self, x: tuple, b) -> tuple:
        out = b.mul_extension(b.exp_u64_extension(self.base, self.count), x) \
            if self.count else x
        self.count = 0
        return out


def _ext_wires(row: int, start: int) -> tuple:
    return (tg.wire(row, start), tg.wire(row, start + 1))


int_or_target = int
