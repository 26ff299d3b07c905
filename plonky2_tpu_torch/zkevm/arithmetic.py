"""256-bit arithmetic STARK table (twin of reference evm/src/arithmetic/).

Verifies EVM-style register arithmetic over 16-bit limbs:

- ADD / SUB / LT / GT via one "add with carry out" identity
  X + Y = Z + CY*2^bits with roles permuted per op (addcy.rs:1-150).
- MUL via the polynomial identity a(x)b(x) - c(x) = (x - B)s(x) evaluated
  mod x^N, where B = 2^limb_bits and s carries the long-multiplication
  carries (mul.rs:1-170).
- DIV / MOD / ADDMOD / SUBMOD / MULMOD (+ the fixed-modulus FP254
  variants) via the general modular identity
  op(a(x), b(x)) - c(x) - q(x)m(x) = (x - B)s(x), with reduced-output
  check, zero-modulus handling and a two-row layout: the op occupies one
  row and its aux values (quotient carries, reduced-output witness) the
  next row (modular.rs:1-110, divmod.rs).
- BYTE via a bit-driven halving tree over the value limbs (byte.rs:1-63).

Every 16-bit limb in the shared columns is range checked against a
RANGE_COUNTER column (0..2^limb_bits-1) with Halo2-style sorted-copy
lookups tied by the STARK permutation argument
(arithmetic_stark.rs:95-240).

The table is parameterised over (val_bits, limb_bits) — the reference
fixes (256, 16) (columns.rs:5-23); tests use narrower registers so the
2^limb_bits-row range table stays small.  Trace generation uses exact
Python integers per operation (replacing the reference's BigInt
machinery) and vectorised numpy for the range-check permutations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gl64
from ..stark.ctl import Column
from ..stark.permutation import PermutationPair
from ..stark.stark import Stark
from .lookup import eval_lookups, permuted_cols

P = gl64.ORDER_INT

# BN254 base-field modulus (extension_tower.rs BN_BASE)
BN_BASE = 21888242871839275222246405745257275088696311157297823662689037894645226208583

BINARY_OPS = ("add", "mul", "sub", "div", "mod", "lt", "gt", "byte",
              "addfp254", "mulfp254", "subfp254")
TERNARY_OPS = ("addmod", "mulmod", "submod")
ALL_OPS = ("add", "mul", "sub", "div", "mod", "addmod", "mulmod",
           "addfp254", "mulfp254", "subfp254", "submod", "lt", "gt", "byte")

MODULAR_OPS = ("div", "mod", "addmod", "mulmod", "submod",
               "addfp254", "mulfp254", "subfp254")


@dataclass(frozen=True)
class Operation:
    """One arithmetic request (mod.rs:111 Operation)."""

    op: str
    input0: int
    input1: int
    input2: int = 0  # modulus for ternary ops

    def result(self, val_bits: int) -> int:
        """Reference semantics (mod.rs:33 BinaryOperator::result)."""
        mask = (1 << val_bits) - 1
        a, b, m = self.input0, self.input1, self.input2
        op = self.op
        if op == "add":
            return (a + b) & mask
        if op == "mul":
            return (a * b) & mask
        if op == "sub":
            return (a - b) & mask
        if op == "div":
            return a // b if b else 0
        if op == "mod":
            return a % b if b else 0
        if op == "lt":
            return int(a < b)
        if op == "gt":
            return int(a > b)
        if op == "byte":
            nbytes = val_bits // 8
            if a >= nbytes:
                return 0
            return (b >> (8 * (nbytes - 1 - a))) & 0xFF
        if op == "addmod":
            return (a + b) % m if m else 0
        if op == "mulmod":
            return (a * b) % m if m else 0
        if op == "submod":
            return (a - b) % m if m else 0
        if op == "addfp254":
            return (a + b) % BN_BASE
        if op == "mulfp254":
            return (a * b) % BN_BASE
        if op == "subfp254":
            return (a - b) % BN_BASE
        raise ValueError(op)


# ------------------------------------------------------------------
# integer-polynomial helpers (utils.rs pol_*), over Python ints

def _to_limbs(x: int, n: int, lb: int) -> list:
    mask = (1 << lb) - 1
    return [(x >> (lb * i)) & mask for i in range(n)]


def _pol_mul_wide(a: list, b: list) -> list:
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] += ai * bj
    return out


def _pol_remove_root(p: list, beta: int) -> list:
    """s with p(x) = (x - beta) s(x): s[0] = -p[0]/beta,
    s[i] = (s[i-1] - p[i])/beta; exact when p(beta) = 0
    (utils.rs:278 pol_remove_root_2exp)."""
    s = []
    acc = 0
    for c in p[:-1]:
        acc = (acc - c) if s else -c
        assert acc % beta == 0, "non-exact root removal"
        acc //= beta
        s.append(acc)
    return s


def _pol_adjoin_root_eval(ctx, s: list, beta: int, n: int) -> list:
    """(x - beta) s(x) truncated to n coefficients, over ctx elements
    (utils.rs:232 pol_adjoin_root)."""
    beta_c = ctx.constant(beta)
    out = []
    for i in range(n):
        c = ctx.zero() - s[i] * beta_c
        if i > 0:
            c = c + s[i - 1]
        out.append(c)
    return out


def _pol_mul_wide_eval(ctx, a: list, b: list) -> list:
    out = [ctx.zero() for _ in range(len(a) + len(b) - 1)]
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] = out[i + j] + ai * bj
    return out


class ArithmeticStark(Stark):
    PUBLIC_INPUTS = 0

    def __init__(self, val_bits: int = 256, limb_bits: int = 16):
        assert val_bits % limb_bits == 0
        self.val_bits = val_bits
        self.limb_bits = limb_bits
        n = val_bits // limb_bits
        assert n & (n - 1) == 0 and n >= 4, "N_LIMBS must be a power of two"
        assert 2 * n < (1 << limb_bits), "carry headroom (aux hi limbs)"
        self.n_limbs = n
        self.beta = 1 << limb_bits
        self.beta_inv = pow(self.beta, P - 2, P)
        # max |aux coefficient| after root removal: ~2N * beta
        self.aux_abs_max = 2 * n * self.beta
        self.range_max = 1 << limb_bits

        # -- column layout (columns.rs:25-114) --------------------------
        self.IS = {op: i for i, op in enumerate(ALL_OPS)}
        start = len(ALL_OPS)
        self.START_SHARED = start
        self.INPUT0 = range(start, start + n)
        self.INPUT1 = range(self.INPUT0.stop, self.INPUT0.stop + n)
        self.INPUT2 = range(self.INPUT1.stop, self.INPUT1.stop + n)
        self.OUTPUT = range(self.INPUT2.stop, self.INPUT2.stop + n)
        self.AUX0 = range(self.OUTPUT.stop, self.OUTPUT.stop + n)
        self.AUX1 = range(self.AUX0.stop, self.AUX0.stop + n)
        self.NUM_SHARED = 6 * n
        self.SHARED = range(start, start + self.NUM_SHARED)
        # modular aux rows (written to the row AFTER the op row):
        self.MOD_OUT_AUX_RED = self.INPUT0        # AUX_REGISTER_0
        self.MOD_IS_ZERO = self.INPUT1.start      # AUX_REGISTER_1.start
        self.MOD_AUX_LO = range(self.INPUT1.start + 1,
                                self.INPUT1.start + 2 * n)  # 2n-1 slots
        self.MOD_AUX_HI = range(self.MOD_AUX_LO.stop,
                                self.MOD_AUX_LO.stop + 2 * n - 1)
        self.MOD_DIV_DENOM_IS_ZERO = self.MOD_AUX_HI.stop
        assert self.MOD_DIV_DENOM_IS_ZERO < self.SHARED.stop
        # byte decomposition (within AUX0; tree in AUX1; inverse in INPUT2)
        nbytes = val_bits // 8
        self.idx_bits = nbytes.bit_length() - 1
        self.bytes_per_limb = limb_bits // 8
        assert self.bytes_per_limb in (1, 2)
        self.BYTE_IDX_BITS = range(self.AUX0.start,
                                   self.AUX0.start + self.idx_bits)
        self.BYTE_IDX_HI = self.BYTE_IDX_BITS.stop
        self.BYTE_LAST_LIMB_LO = self.BYTE_IDX_HI + 1  # stores 256*lo
        self.BYTE_LAST_LIMB_HI = self.BYTE_IDX_HI + 2
        self.BYTE_IDX_IS_LARGE = self.BYTE_IDX_HI + 3
        assert self.BYTE_IDX_IS_LARGE < self.AUX0.stop
        self.BYTE_TREE = self.AUX1
        self.inv_limbs = -(-64 // limb_bits)
        assert self.inv_limbs <= n

        self.RANGE_COUNTER = start + self.NUM_SHARED
        self.RC = range(self.RANGE_COUNTER + 1,
                        self.RANGE_COUNTER + 1 + 2 * self.NUM_SHARED)
        self.COLUMNS = self.RC.stop

        self.has_fp254 = val_bits == 256

    # ------------------------------------------------------------------
    # CTL exports (arithmetic_stark.rs:52 ctl_arithmetic_rows)

    def ctl_data(self) -> list:
        """Op flags then each register's limbs packed into 32-bit bus
        values (arithmetic_stark.rs:31 packs pairs of its fixed 16-bit
        limbs; here the group size is 32/limb_bits so the bus layout —
        8 u32 values per register, matching the CPU word limbs,
        cpu.py ctl_looking_arithmetic — is invariant under limb_bits)."""
        res = Column.singles(self.IS[op] for op in ALL_OPS)
        group = 32 // self.limb_bits
        for reg in (self.INPUT0, self.INPUT1, self.INPUT2, self.OUTPUT):
            for i in range(self.n_limbs // group):
                c0 = reg.start + group * i
                res.append(Column.linear(
                    [(c0 + j, 1 << (self.limb_bits * j))
                     for j in range(group)]))
        return res

    def ctl_filter(self) -> Column:
        return Column.sum_cols(self.IS[op] for op in ALL_OPS)

    # ------------------------------------------------------------------
    # trace generation

    def generate_trace(self, operations: list) -> np.ndarray:
        """(COLUMNS, n_rows) u64; modular ops emit two rows
        (arithmetic_stark.rs:120 generate_trace)."""
        rows = []
        for op in operations:
            lv = np.zeros(self.COLUMNS, np.uint64)
            nv = np.zeros(self.COLUMNS, np.uint64)
            two_row = self._op_to_rows(op, lv, nv)
            rows.append(lv)
            if two_row:
                rows.append(nv)
        n = max(self.range_max, 1 << max(0, (max(1, len(rows)) - 1)
                                         .bit_length()))
        t = np.zeros((self.COLUMNS, n), np.uint64)
        for i, r in enumerate(rows):
            t[:, i] = r
        self._generate_range_checks(t)
        return t

    def _generate_range_checks(self, t: np.ndarray) -> None:
        """(arithmetic_stark.rs:95 generate_range_checks)"""
        n = t.shape[-1]
        counter = np.minimum(np.arange(n, dtype=np.uint64),
                             np.uint64(self.range_max - 1))
        t[self.RANGE_COUNTER] = counter
        for k, c in enumerate(self.SHARED):
            assert np.all(t[c] < self.range_max), f"col {c} exceeds range"
            rc = self.RC.start + 2 * k
            t[rc], t[rc + 1] = permuted_cols(t[c], counter)

    def _set_reg(self, lv, reg: range, x: int) -> None:
        lv[reg.start:reg.stop] = _to_limbs(x, self.n_limbs, self.limb_bits)

    def _op_to_rows(self, op: Operation, lv, nv) -> bool:
        """Fill the op row (and aux row for two-row ops); returns whether
        the aux row is used (mod.rs:167 Operation::to_rows)."""
        lv[self.IS[op.op]] = 1
        name = op.op
        if name in ("add", "sub", "lt", "gt"):
            self._gen_addcy(op, lv)
            return False
        if name == "mul":
            self._gen_mul(op, lv)
            return False
        if name == "byte":
            self._gen_byte(op, lv)
            return False
        assert name in MODULAR_OPS
        self._gen_modular(op, lv, nv)
        return True

    def _gen_addcy(self, op: Operation, lv) -> None:
        """(addcy.rs:31 generate)"""
        a, b = op.input0, op.input1
        mask = (1 << self.val_bits) - 1
        self._set_reg(lv, self.INPUT0, a)
        self._set_reg(lv, self.INPUT1, b)
        if op.op == "add":
            self._set_reg(lv, self.OUTPUT, (a + b) & mask)
            self._set_reg(lv, self.AUX0, int(a + b > mask))
        elif op.op == "sub":
            self._set_reg(lv, self.OUTPUT, (a - b) & mask)
            self._set_reg(lv, self.AUX0, int(a < b))
        elif op.op == "lt":
            self._set_reg(lv, self.AUX0, (a - b) & mask)
            self._set_reg(lv, self.OUTPUT, int(a < b))
        else:  # gt
            self._set_reg(lv, self.AUX0, (b - a) & mask)
            self._set_reg(lv, self.OUTPUT, int(b < a))

    def _gen_mul(self, op: Operation, lv) -> None:
        """(mul.rs:72 generate)"""
        n, lb = self.n_limbs, self.limb_bits
        a, b = op.input0, op.input1
        mask = (1 << self.val_bits) - 1
        self._set_reg(lv, self.INPUT0, a)
        self._set_reg(lv, self.INPUT1, b)
        c = (a * b) & mask
        self._set_reg(lv, self.OUTPUT, c)
        al = _to_limbs(a, n, lb)
        bl = _to_limbs(b, n, lb)
        cl = _to_limbs(c, n, lb)
        unreduced = _pol_mul_wide(al, bl)[:n]
        # the dropped carry out of limb n-1 (mul.rs:96-110)
        cy = (sum(u << (lb * i) for i, u in enumerate(unreduced)) - c) >> (
            lb * n)
        p = [u - ci for u, ci in zip(unreduced, cl)]
        s = _pol_remove_root(p + [0], self.beta)[:n]
        s[n - 1] = -cy
        self._store_aux(lv, s, self.AUX0, self.AUX1)

    def _store_aux(self, lv, coeffs: list, lo_range, hi_range) -> None:
        """Offset signed aux coefficients by aux_abs_max and store
        (lo, hi) limb pairs (mul.rs:111-117)."""
        for k, c in enumerate(coeffs):
            v = c + self.aux_abs_max
            assert 0 <= v <= 2 * self.aux_abs_max, "aux coefficient range"
            lv[lo_range.start + k] = v & (self.beta - 1)
            lv[hi_range.start + k] = v >> self.limb_bits

    def _aux_eval(self, ctx, lv_or_nv, lo_range, hi_range, count: int) -> list:
        """Reassemble signed aux coefficients from (lo, hi) columns
        (mul.rs:129-139)."""
        beta_c = ctx.constant(self.beta)
        off = ctx.constant(self.aux_abs_max)
        return [lv_or_nv[lo_range.start + k] + lv_or_nv[hi_range.start + k]
                * beta_c - off for k in range(count)]

    def _gen_modular(self, op: Operation, lv, nv) -> None:
        """(modular.rs:212 generate_modular_op + generate, divmod.rs:19)"""
        n, lb = self.n_limbs, self.limb_bits
        name = op.op
        a, b = op.input0, op.input1
        if name in ("div", "mod"):
            m = b
            self._set_reg(lv, self.INPUT0, a)
            self._set_reg(lv, self.INPUT1, m)
            pol_input = _to_limbs(a, n, lb) + [0] * (n - 1)
        else:
            m = BN_BASE if name.endswith("fp254") else op.input2
            self._set_reg(lv, self.INPUT0, a)
            self._set_reg(lv, self.INPUT1, b)
            self._set_reg(lv, self.INPUT2, m)
            al = _to_limbs(a, n, lb)
            bl = _to_limbs(b, n, lb)
            if name in ("addmod", "addfp254"):
                pol_input = [x + y for x, y in zip(al, bl)] + [0] * (n - 1)
            elif name in ("submod", "subfp254"):
                pol_input = [x - y for x, y in zip(al, bl)] + [0] * (n - 1)
            else:
                pol_input = _pol_mul_wide(al, bl)

        modulus = m
        mod_is_zero = 0
        modulus_limbs = _to_limbs(m, n, lb)
        if modulus == 0:
            mod_is_zero = 1
            if name == "div":
                modulus = 1 << self.val_bits  # limbs stay zero
            else:
                modulus = 1
                modulus_limbs[0] = 1

        input_val = sum(c << (lb * i) for i, c in enumerate(pol_input))
        output = input_val % modulus
        out_limbs = _to_limbs(output, n, lb)
        quot = (input_val - output) // modulus
        neg_quot = quot < 0
        if neg_quot:
            assert name in ("submod", "subfp254")
        quot_limbs = _to_limbs(abs(quot), 2 * n, lb)
        if neg_quot:
            quot_limbs = [-q for q in quot_limbs]

        # out_aux_red: output - modulus + 2^val_bits (reduced-output check)
        out_aux_red = _to_limbs((1 << self.val_bits) - modulus + output,
                                n, lb)

        # constraint poly = input - output - quot*modulus, then /(x - beta)
        p = list(pol_input) + [0]
        for i, c in enumerate(out_limbs):
            p[i] -= c
        qm = _pol_mul_wide(quot_limbs, modulus_limbs)
        assert all(c == 0 for c in qm[2 * n:])
        for i in range(2 * n):
            p[i] -= qm[i]
        s = _pol_remove_root(p, self.beta)
        assert len(s) == 2 * n - 1
        # top-coefficient consistency: x^{2n-1} of (x-beta)s(x) is s[2n-2]
        assert p[-1] == s[-1], "modular constraint poly not divisible"
        self._store_aux(nv, s, self.MOD_AUX_LO, self.MOD_AUX_HI)

        # quotient encoding (modular.rs:309-337): SUB* may be negative —
        # offset low half by beta-1, sign bit in the high half's first limb
        if name in ("submod", "subfp254"):
            assert all(q == 0 for q in quot_limbs[n:])
            if neg_quot:
                quot_enc = [q + self.beta - 1 for q in quot_limbs[:n]]
                quot_enc += [1] + [0] * (n - 1)
            else:
                quot_enc = quot_limbs[:n] + [0] * n
        else:
            quot_enc = quot_limbs
        assert all(0 <= q < self.beta for q in quot_enc)

        nv[self.MOD_IS_ZERO] = mod_is_zero
        for k, c in enumerate(out_aux_red):
            nv[self.MOD_OUT_AUX_RED.start + k] = c
        nv[self.MOD_DIV_DENOM_IS_ZERO] = mod_is_zero * (name == "div")

        if name == "div":
            lv[self.OUTPUT.start:self.OUTPUT.stop] = quot_enc[:n]
            assert all(q == 0 for q in quot_enc[n:])
            for k, c in enumerate(out_limbs):
                lv[self.AUX0.start + k] = c
        elif name == "mod":
            self._set_reg(lv, self.OUTPUT, output)
            lv[self.AUX0.start:self.AUX0.stop] = quot_enc[:n]
            assert all(q == 0 for q in quot_enc[n:])
        else:
            self._set_reg(lv, self.OUTPUT, output)
            lv[self.AUX0.start:self.AUX0.stop] = quot_enc[:n]
            lv[self.AUX1.start:self.AUX1.stop] = quot_enc[n:]

    def _gen_byte(self, op: Operation, lv) -> None:
        """(byte.rs:108 generate)"""
        n, lb = self.n_limbs, self.limb_bits
        idx, val = op.input0, op.input1
        self._set_reg(lv, self.INPUT0, idx)
        self._set_reg(lv, self.INPUT1, val)
        nb = self.idx_bits
        idx0 = idx & (self.beta - 1)
        for i in range(nb):
            lv[self.BYTE_IDX_BITS.start + i] = (idx0 >> i) & 1
        lv[self.BYTE_IDX_HI] = idx0 >> nb

        hi_limb_sum = ((idx0 >> nb)
                       + sum(_to_limbs(idx, n, lb)[1:])) % P
        is_large = int(hi_limb_sum != 0)
        inv = pow(hi_limb_sum, P - 2, P) if is_large else 1
        for k in range(self.inv_limbs):
            lv[self.INPUT2.start + k] = (inv >> (lb * k)) & (self.beta - 1)
        lv[self.BYTE_IDX_IS_LARGE] = is_large

        # selection tree over the limbs, driven by NEGATED idx bits
        # (byte indexing counts from the most significant end)
        limbs = _to_limbs(val, n, lb)
        dest = self.BYTE_TREE.start
        k = n.bit_length() - 1
        cur = limbs
        for t in range(k):
            bit = (idx0 >> (nb - 1 - t)) & 1
            half = len(cur) // 2
            cur = cur[:half] if bit else cur[half:]
            for v in cur:
                lv[dest] = v
                dest += 1
        (last_limb,) = cur
        if self.bytes_per_limb == 2:
            lo, hi = last_limb & 0xFF, last_limb >> 8
            lv[self.BYTE_LAST_LIMB_LO] = lo << 8
            lv[self.BYTE_LAST_LIMB_HI] = hi
            out_byte = lo if (idx0 & 1) else hi
        else:
            out_byte = last_limb
        lv[dest] = out_byte
        self._set_reg(lv, self.OUTPUT, 0 if is_large else out_byte)
        assert dest == self.BYTE_TREE.stop - 1

    # ------------------------------------------------------------------
    # constraints

    def eval_generic(self, ctx, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = ctx.one()

        # range-check lookups + counter shape (arithmetic_stark.rs:166)
        for k in range(self.NUM_SHARED):
            eval_lookups(ctx, vars, yield_constr, self.RC.start + 2 * k,
                         self.RC.start + 2 * k + 1)
        rc1, rc2 = lv[self.RANGE_COUNTER], nv[self.RANGE_COUNTER]
        yield_constr.constraint_first_row(rc1)
        incr = rc2 - rc1
        yield_constr.constraint_transition(incr * incr - incr)
        yield_constr.constraint_last_row(
            rc1 - ctx.constant(self.range_max - 1))

        self._eval_addcy_ops(ctx, lv, yield_constr)
        self._eval_mul(ctx, lv, yield_constr)
        self._eval_divmod(ctx, lv, nv, yield_constr)
        self._eval_modular(ctx, lv, nv, yield_constr)
        self._eval_byte(ctx, lv, yield_constr)

    def _reg(self, lv, r: range) -> list:
        return [lv[i] for i in r]

    def _eval_addcy(self, ctx, yield_constr, filt, x, y, z, given_cy,
                    two_row: bool) -> None:
        """x + y == z + cy*2^val_bits (addcy.rs:98
        eval_packed_generic_addcy)."""
        n = self.n_limbs
        overflow = ctx.constant(self.beta)
        beta_inv = ctx.constant(self.beta_inv)
        emit = (yield_constr.constraint_transition if two_row
                else yield_constr.constraint)
        cy = ctx.zero()
        for xi, yi, zi in zip(x, y, z):
            t = cy + xi + yi - zi
            emit(filt * t * (overflow - t))
            cy = t * beta_inv
        if two_row:
            emit(filt * (cy - given_cy[0]))
        else:
            one = ctx.one()
            yield_constr.constraint(filt * given_cy[0] * (given_cy[0] - one))
            yield_constr.constraint(filt * (cy - given_cy[0]))
        for i in range(1, n):
            emit(filt * given_cy[i])

    def _eval_addcy_ops(self, ctx, lv, yield_constr) -> None:
        """(addcy.rs:151 eval_packed_generic)"""
        in0 = self._reg(lv, self.INPUT0)
        in1 = self._reg(lv, self.INPUT1)
        out = self._reg(lv, self.OUTPUT)
        aux = self._reg(lv, self.AUX0)
        self._eval_addcy(ctx, yield_constr, lv[self.IS["add"]],
                         in0, in1, out, aux, False)
        self._eval_addcy(ctx, yield_constr, lv[self.IS["sub"]],
                         in1, out, in0, aux, False)
        self._eval_addcy(ctx, yield_constr, lv[self.IS["lt"]],
                         in1, aux, in0, out, False)
        self._eval_addcy(ctx, yield_constr, lv[self.IS["gt"]],
                         in0, aux, in1, out, False)

    def _eval_mul(self, ctx, lv, yield_constr) -> None:
        """(mul.rs:119 eval_packed_generic)"""
        n = self.n_limbs
        is_mul = lv[self.IS["mul"]]
        a = self._reg(lv, self.INPUT0)
        b = self._reg(lv, self.INPUT1)
        c = self._reg(lv, self.OUTPUT)
        aux = self._aux_eval(ctx, lv, self.AUX0, self.AUX1, n)
        # constr = a(x)b(x) - c(x) - (x - beta)s(x), mod x^n
        prod = _pol_mul_wide_eval(ctx, a, b)[:n]
        rhs = _pol_adjoin_root_eval(ctx, aux, self.beta, n)
        for i in range(n):
            yield_constr.constraint(is_mul * (prod[i] - c[i] - rhs[i]))

    def _modular_constr_poly(self, ctx, lv, nv, yield_constr, filt,
                             output: list, modulus: list,
                             quot: list) -> list:
        """c(x) + q(x)m(x) + (x - beta)s(x) plus reduced-output and
        zero-modulus checks (modular.rs:428 modular_constr_poly)."""
        n = self.n_limbs
        one = ctx.one()
        mod_is_zero = nv[self.MOD_IS_ZERO]
        yield_constr.constraint_transition(
            filt * (mod_is_zero * mod_is_zero - mod_is_zero))
        limb_sum = modulus[0]
        for mi in modulus[1:]:
            limb_sum = limb_sum + mi
        yield_constr.constraint_transition(filt * limb_sum * mod_is_zero)
        modulus = [modulus[0] + mod_is_zero] + list(modulus[1:])

        div_denom_is_zero = nv[self.MOD_DIV_DENOM_IS_ZERO]
        yield_constr.constraint_transition(
            filt * (mod_is_zero * lv[self.IS["div"]] - div_denom_is_zero))
        output_adj = [output[0] + div_denom_is_zero] + list(output[1:])

        # output < modulus: modulus + out_aux_red == output + lt*2^bits
        out_aux_red = [nv[i] for i in self.MOD_OUT_AUX_RED]
        is_less_than = [one - div_denom_is_zero] + [ctx.zero()] * (n - 1)
        self._eval_addcy(ctx, yield_constr, filt, modulus, out_aux_red,
                         output_adj, is_less_than, True)

        prod = _pol_mul_wide_eval(ctx, quot, modulus)
        for c in prod[2 * n:]:
            yield_constr.constraint_transition(filt * c)
        constr = [prod[i] + output[i] if i < n else prod[i]
                  for i in range(2 * n)]
        aux = self._aux_eval(ctx, nv, self.MOD_AUX_LO, self.MOD_AUX_HI,
                             2 * n - 1) + [ctx.zero()]
        rhs = _pol_adjoin_root_eval(ctx, aux, self.beta, 2 * n)
        return [ci + ri for ci, ri in zip(constr, rhs)]

    def _submod_constr_poly(self, ctx, lv, nv, yield_constr, filt,
                            output, modulus, quot) -> list:
        """De-bias the possibly-negative quotient then defer to the
        modular poly (modular.rs:500 submod_constr_poly)."""
        n = self.n_limbs
        one = ctx.one()
        sign = quot[n]
        yield_constr.constraint(filt * sign * (sign - one))
        off = ctx.constant(self.beta - 1)
        lo = [q - off * sign for q in quot[:n]]
        for d in quot[n + 1:]:
            yield_constr.constraint(filt * d)
        return self._modular_constr_poly(
            ctx, lv, nv, yield_constr, filt, output, modulus,
            lo + [ctx.zero()] * n)

    def _eval_modular(self, ctx, lv, nv, yield_constr) -> None:
        """(modular.rs:539 eval_packed)"""
        n = self.n_limbs
        if self.has_fp254:
            bn254_filter = (lv[self.IS["addfp254"]] + lv[self.IS["mulfp254"]]
                            + lv[self.IS["subfp254"]])
        else:
            bn254_filter = ctx.zero()
        filt = (lv[self.IS["addmod"]] + lv[self.IS["submod"]]
                + lv[self.IS["mulmod"]] + bn254_filter)
        yield_constr.constraint_last_row(filt)

        modulus = self._reg(lv, self.INPUT2)
        if self.has_fp254:
            bn = _to_limbs(BN_BASE, n, self.limb_bits)
            for mi, bi in zip(modulus, bn):
                yield_constr.constraint_transition(
                    bn254_filter * (mi - ctx.constant(bi)))

        output = self._reg(lv, self.OUTPUT)
        quot = self._reg(lv, self.AUX0) + self._reg(lv, self.AUX1)

        add_filter = lv[self.IS["addmod"]]
        sub_filter = lv[self.IS["submod"]]
        mul_filter = lv[self.IS["mulmod"]]
        if self.has_fp254:
            add_filter = add_filter + lv[self.IS["addfp254"]]
            sub_filter = sub_filter + lv[self.IS["subfp254"]]
            mul_filter = mul_filter + lv[self.IS["mulfp254"]]
        addmul_filter = add_filter + mul_filter

        sub_poly = self._submod_constr_poly(
            ctx, lv, nv, yield_constr, sub_filter, output, modulus, quot)
        mod_poly = self._modular_constr_poly(
            ctx, lv, nv, yield_constr, addmul_filter, output, modulus, quot)

        in0 = self._reg(lv, self.INPUT0)
        in1 = self._reg(lv, self.INPUT1)
        zeros = [ctx.zero()] * (n - 1)
        add_input = [x + y for x, y in zip(in0, in1)] + zeros
        sub_input = [x - y for x, y in zip(in0, in1)] + zeros
        mul_input = _pol_mul_wide_eval(ctx, in0, in1)

        for inp, f, poly in ((add_input, add_filter, mod_poly),
                             (sub_input, sub_filter, sub_poly),
                             (mul_input, mul_filter, mod_poly)):
            for i in range(2 * n):
                c = poly[i] - inp[i] if i < len(inp) else poly[i]
                yield_constr.constraint_transition(f * c)

    def _eval_divmod(self, ctx, lv, nv, yield_constr) -> None:
        """num == quo*den + rem with rem < den (divmod.rs:70,102)."""
        n = self.n_limbs
        zeros = [ctx.zero()] * n
        for name, quo_range, rem_range in (
                ("div", self.OUTPUT, self.AUX0),
                ("mod", self.AUX0, self.OUTPUT)):
            filt = lv[self.IS[name]]
            yield_constr.constraint_last_row(filt)
            num = self._reg(lv, self.INPUT0)
            den = self._reg(lv, self.INPUT1)
            quo = self._reg(lv, quo_range) + zeros
            rem = self._reg(lv, rem_range)
            poly = self._modular_constr_poly(
                ctx, lv, nv, yield_constr, filt, rem, den, quo)
            for i in range(2 * n):
                c = poly[i] - num[i] if i < n else poly[i]
                yield_constr.constraint_transition(filt * c)

    def _eval_byte(self, ctx, lv, yield_constr) -> None:
        """(byte.rs:200 eval_packed)"""
        n, nb = self.n_limbs, self.idx_bits
        one = ctx.one()
        is_byte = lv[self.IS["byte"]]
        idx = self._reg(lv, self.INPUT0)
        val = self._reg(lv, self.INPUT1)
        out = self._reg(lv, self.OUTPUT)

        bits = [lv[i] for i in self.BYTE_IDX_BITS]
        idx0_lo = ctx.zero()
        for i, bit in enumerate(bits):
            yield_constr.constraint(is_byte * (bit * bit - bit))
            idx0_lo = idx0_lo + bit * ctx.constant(1 << i)
        idx0_hi = lv[self.BYTE_IDX_HI] * ctx.constant(1 << nb)
        yield_constr.constraint(is_byte * (idx[0] - (idx0_lo + idx0_hi)))

        # selection tree: level t keyed by bit nb-1-t, negated
        k = n.bit_length() - 1
        cur = val
        dest = self.BYTE_TREE.start
        for t in range(k):
            bit = bits[nb - 1 - t]
            half = len(cur) // 2
            new = []
            for i in range(half):
                limb = bit * cur[i] + (one - bit) * cur[i + half]
                slot = lv[dest]
                yield_constr.constraint(is_byte * (slot - limb))
                new.append(slot)
                dest += 1
            cur = new
        (last_limb,) = cur

        if self.bytes_per_limb == 2:
            base8 = ctx.constant(1 << 8)
            w = lv[self.BYTE_LAST_LIMB_LO]  # 256 * lo byte
            hi = lv[self.BYTE_LAST_LIMB_HI]
            # last_limb == w/256 + hi*256  <=>  w + 256*(256*hi - L) == 0
            yield_constr.constraint(
                is_byte * (w + base8 * (base8 * hi - last_limb)))
            bit0 = bits[0]
            sel = bit0 * w + (one - bit0) * base8 * hi
            byte_slot = lv[dest]
            yield_constr.constraint(is_byte * (base8 * byte_slot - sel))
        else:
            byte_slot = lv[dest]
            yield_constr.constraint(is_byte * (byte_slot - last_limb))
        expected = byte_slot

        hi_limb_sum = lv[self.BYTE_IDX_HI]
        for x in idx[1:]:
            hi_limb_sum = hi_limb_sum + x
        is_large = lv[self.BYTE_IDX_IS_LARGE]
        yield_constr.constraint(is_byte * (is_large * is_large - is_large))
        yield_constr.constraint(is_byte * hi_limb_sum * (is_large - one))
        inv = ctx.zero()
        for kk in range(self.inv_limbs):
            inv = inv + lv[self.INPUT2.start + kk] * ctx.constant(
                1 << (self.limb_bits * kk))
        yield_constr.constraint(is_byte * (hi_limb_sum * inv - is_large))

        yield_constr.constraint(is_byte * (out[0] - (one - is_large)
                                           * expected))
        for x in out[1:]:
            yield_constr.constraint(is_byte * x)

    def constraint_degree(self) -> int:
        return 3

    def permutation_pairs(self) -> list:
        """(arithmetic_stark.rs:228)"""
        pairs = []
        for k, c in enumerate(self.SHARED):
            rc = self.RC.start + 2 * k
            pairs.append(PermutationPair.singletons(c, rc))
            pairs.append(PermutationPair.singletons(rc + 1,
                                                    self.RANGE_COUNTER))
        return pairs
