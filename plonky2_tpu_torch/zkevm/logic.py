"""Bitwise-logic STARK table (twin of reference evm/src/logic.rs).

256-bit AND/OR/XOR: inputs are bit-decomposed (256 bit columns each), the
result is packed into 8 x 32-bit limbs.  One linear identity covers all
three ops:  x OP y = sum_coeff*(x + y) + and_coeff*(x AND y)  with
(sum, and) = (0, 1) / (1, -1) / (1, -2) for AND / OR / XOR
(logic.rs:197-202).  Trace generation is vectorised numpy over all
operations at once instead of the reference's per-row loop.

The value width is parameterised (the reference fixes VAL_BITS=256,
logic.rs:22); tests use narrower widths to keep CPU circuit shapes small.
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..stark.ctl import Column
from ..stark.stark import Stark

P = gl64.ORDER_INT

PACKED_LIMB_BITS = 32

OPS = ("and", "or", "xor")


def op_result(op: str, a: int, b: int) -> int:
    return {"and": a & b, "or": a | b, "xor": a ^ b}[op]


class LogicStark(Stark):
    PUBLIC_INPUTS = 0

    # column layout (logic.rs:28-52)
    IS_AND = 0
    IS_OR = 1
    IS_XOR = 2

    def __init__(self, val_bits: int = 256):
        assert val_bits % PACKED_LIMB_BITS == 0
        self.val_bits = val_bits
        self.packed_len = val_bits // PACKED_LIMB_BITS
        self.INPUT0 = range(3, 3 + val_bits)
        self.INPUT1 = range(self.INPUT0.stop, self.INPUT0.stop + val_bits)
        self.RESULT = range(self.INPUT1.stop,
                            self.INPUT1.stop + self.packed_len)
        self.COLUMNS = self.RESULT.stop

    def _limb_bit_cols(self, input_bits: range):
        for i in range(self.packed_len):
            start = input_bits.start + i * PACKED_LIMB_BITS
            yield range(start, start + PACKED_LIMB_BITS)

    def ctl_data(self) -> list:
        """Columns exported over the CTL bus: op flags, inputs re-packed to
        32-bit limbs from their bits, result limbs (logic.rs:54)."""
        res = Column.singles([self.IS_AND, self.IS_OR, self.IS_XOR])
        for input_bits in (self.INPUT0, self.INPUT1):
            res += [Column.le_bits(cols)
                    for cols in self._limb_bit_cols(input_bits)]
        res += Column.singles(self.RESULT)
        return res

    def ctl_filter(self) -> Column:
        return Column.sum_cols([self.IS_AND, self.IS_OR, self.IS_XOR])

    def generate_trace(self, operations: list, min_rows: int = 0) -> np.ndarray:
        """operations: list of (op, input0, input1) with op in OPS and
        val_bits-wide int inputs.  Returns (COLUMNS, n) u64 (logic.rs:138)."""
        n_ops = len(operations)
        n = 1 << max(0, (max(1, n_ops, min_rows) - 1).bit_length())
        trace = np.zeros((self.COLUMNS, n), np.uint64)
        if n_ops == 0:
            return trace
        nbytes = self.val_bits // 8
        ops = np.array([OPS.index(op) for op, _, _ in operations])
        trace[self.IS_AND, :n_ops] = ops == 0
        trace[self.IS_OR, :n_ops] = ops == 1
        trace[self.IS_XOR, :n_ops] = ops == 2
        for in_range, vals in ((self.INPUT0, [a for _, a, _ in operations]),
                               (self.INPUT1, [b for _, _, b in operations])):
            byts = np.frombuffer(
                b"".join(v.to_bytes(nbytes, "little") for v in vals),
                dtype=np.uint8).reshape(n_ops, nbytes)
            bits = np.unpackbits(byts, axis=1, bitorder="little")
            trace[in_range.start:in_range.stop, :n_ops] = bits.T
        results = [op_result(op, a, b) for op, a, b in operations]
        for j in range(self.packed_len):
            trace[self.RESULT.start + j, :n_ops] = [
                (r >> (32 * j)) & 0xFFFFFFFF for r in results]
        return trace

    def eval_generic(self, ctx, vars, yield_constr) -> None:
        lv = vars.local_values
        one = ctx.one()
        is_and = lv[self.IS_AND]
        is_or = lv[self.IS_OR]
        is_xor = lv[self.IS_XOR]
        # x OP y = sum_coeff*(x+y) + and_coeff*(x AND y) (logic.rs:197)
        sum_coeff = is_or + is_xor
        and_coeff = is_and - is_or - is_xor * ctx.constant(2)

        for input_bits in (self.INPUT0, self.INPUT1):
            for i in input_bits:
                yield_constr.constraint(lv[i] * (lv[i] - one))

        for result_col, x_cols, y_cols in zip(
                self.RESULT, self._limb_bit_cols(self.INPUT0),
                self._limb_bit_cols(self.INPUT1)):
            x = ctx.zero()
            y = ctx.zero()
            x_land_y = ctx.zero()
            for i, (xc, yc) in enumerate(zip(x_cols, y_cols)):
                w = ctx.constant(1 << i)
                x = x + lv[xc] * w
                y = y + lv[yc] * w
                x_land_y = x_land_y + lv[xc] * lv[yc] * w
            x_op_y = sum_coeff * (x + y) + and_coeff * x_land_y
            yield_constr.constraint(lv[result_col] - x_op_y)

    def constraint_degree(self) -> int:
        return 3
