"""Keccak-256 sponge STARK (twin of reference
evm/src/keccak_sponge/keccak_sponge_stark.rs).

Each row absorbs one rate-sized block: either a full input block
(is_full_input_block = 1) or the final, padded block (exactly one of the
is_final_input_len[i] flags set, i = remaining input length).  The AIR
chains the sponge state across rows of one operation and resets it
between operations; the actual permutation, byte reads and rate XOR are
NOT constrained here — they are delegated over CTLs to the Keccak-f
table, the memory table and the logic table respectively
(keccak_sponge_stark.rs:26-153 ctl_* exports).

State chunk order: u32 pairs (lo, hi) of the 25 standard u64 lanes,
lane index i = x + 5y — matching KeccakStark's CTL limb order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..field import gl64
from ..hash.keccak import keccak_f as _keccak_f_yx
from ..stark.ctl import Column
from ..stark.stark import Stark

KECCAK_WIDTH_BYTES = 200
KECCAK_WIDTH_U32S = 50
KECCAK_RATE_BYTES = 136
KECCAK_RATE_U32S = 34
KECCAK_CAPACITY_U32S = 16

U64 = np.uint64


def keccakf_u32s(chunks: np.ndarray) -> np.ndarray:
    """Permutation on 50 u32 chunks (pairs = u64 lanes, i = x + 5y)."""
    lanes = chunks[0::2].astype(U64) | (chunks[1::2].astype(U64) << U64(32))
    state = np.zeros((1, 5, 5), U64)
    for i in range(25):
        y, x = divmod(i, 5)
        state[0, y, x] = lanes[i]  # hash-layer kernel is [.., y, x]
    out = _keccak_f_yx(state)[0]
    res = np.zeros(50, np.uint64)
    for i in range(25):
        y, x = divmod(i, 5)
        res[2 * i] = out[y, x] & U64(0xFFFFFFFF)
        res[2 * i + 1] = out[y, x] >> U64(32)
    return res


@dataclass(frozen=True)
class KeccakSpongeOp:
    """(keccak_sponge_stark.rs:156)"""

    context: int
    segment: int
    virt: int
    timestamp: int
    input: bytes


class KeccakSpongeStark(Stark):
    PUBLIC_INPUTS = 0

    def __init__(self):
        c = iter(range(10**6))
        self.IS_FULL_INPUT_BLOCK = next(c)
        self.CONTEXT = next(c)
        self.SEGMENT = next(c)
        self.VIRT = next(c)
        self.TIMESTAMP = next(c)
        self.LEN = next(c)
        self.ALREADY_ABSORBED = next(c)
        self.IS_FINAL_INPUT_LEN = range(
            self.ALREADY_ABSORBED + 1,
            self.ALREADY_ABSORBED + 1 + KECCAK_RATE_BYTES)
        self.ORIGINAL_RATE = range(
            self.IS_FINAL_INPUT_LEN.stop,
            self.IS_FINAL_INPUT_LEN.stop + KECCAK_RATE_U32S)
        self.ORIGINAL_CAPACITY = range(
            self.ORIGINAL_RATE.stop,
            self.ORIGINAL_RATE.stop + KECCAK_CAPACITY_U32S)
        self.BLOCK_BYTES = range(
            self.ORIGINAL_CAPACITY.stop,
            self.ORIGINAL_CAPACITY.stop + KECCAK_RATE_BYTES)
        self.XORED_RATE = range(self.BLOCK_BYTES.stop,
                                self.BLOCK_BYTES.stop + KECCAK_RATE_U32S)
        self.UPDATED_STATE = range(self.XORED_RATE.stop,
                                   self.XORED_RATE.stop + KECCAK_WIDTH_U32S)
        self.COLUMNS = self.UPDATED_STATE.stop

    # ---- CTL exports (keccak_sponge_stark.rs:26-153) -------------------
    def ctl_looked_data(self) -> list:
        """What the CPU looks up: address, len, timestamp, 256-bit hash."""
        return Column.singles(
            [self.CONTEXT, self.SEGMENT, self.VIRT, self.LEN, self.TIMESTAMP]
            + list(self.UPDATED_STATE[:8]))

    def ctl_looked_filter(self) -> Column:
        return Column.sum_cols(self.IS_FINAL_INPUT_LEN)

    def ctl_looking_keccak(self) -> list:
        """The permutation call: 50 input + 50 output u32 chunks."""
        return Column.singles(list(self.XORED_RATE)
                              + list(self.ORIGINAL_CAPACITY)
                              + list(self.UPDATED_STATE))

    def ctl_looking_keccak_filter(self) -> Column:
        return Column.sum_cols([self.IS_FULL_INPUT_BLOCK]
                               + list(self.IS_FINAL_INPUT_LEN))

    def ctl_looking_memory(self, i: int) -> list:
        """Read of input byte i: memory-bus row (is_read, address triple,
        8 value limbs, timestamp)."""
        return [Column.one(),
                Column.single(self.CONTEXT),
                Column.single(self.SEGMENT),
                Column.linear([(self.VIRT, 1), (self.ALREADY_ABSORBED, 1)],
                              constant=i),
                Column.single(self.BLOCK_BYTES[i])] + \
            [Column.zero() for _ in range(7)] + \
            [Column.single(self.TIMESTAMP)]

    def ctl_looking_memory_filter(self, i: int) -> Column:
        """Byte i is read on full blocks, or on a final block whose
        length exceeds i (pad bytes are not memory reads)."""
        return Column.sum_cols([self.IS_FULL_INPUT_BLOCK]
                               + list(self.IS_FINAL_INPUT_LEN[i + 1:]))

    def num_logic_ctls(self) -> int:
        return -(-KECCAK_RATE_BYTES // 32)

    def ctl_looking_logic(self, i: int, val_bits: int = 256) -> list:
        """XOR of 8 rate u32s with 8 block u32s -> 8 xored u32s, via the
        logic table's (flags, inputs, result) bus row."""
        u32s_per = 8
        res = [Column.zero(), Column.zero(), Column.one()]  # and, or, xor
        for reg in (self.ORIGINAL_RATE, None, self.XORED_RATE):
            for j in range(u32s_per):
                k = i * u32s_per + j
                if reg is None:  # block bytes packed to u32
                    if 4 * k + 3 < KECCAK_RATE_BYTES:
                        res.append(Column.le_bytes(
                            self.BLOCK_BYTES[4 * k:4 * k + 4]))
                    else:
                        res.append(Column.zero())
                elif k < len(reg):
                    res.append(Column.single(reg[k]))
                else:
                    res.append(Column.zero())
        return res

    def ctl_looking_logic_filter(self) -> Column:
        return self.ctl_looking_keccak_filter()

    # ---- trace generation ---------------------------------------------
    def generate_trace(self, operations: list,
                       min_rows: int = 0) -> np.ndarray:
        rows = []
        for op in operations:
            rows.extend(self._rows_for_op(op))
        n = 1 << max(max(1, len(rows), min_rows) - 1, 0).bit_length()
        t = np.zeros((self.COLUMNS, n), np.uint64)
        for i, r in enumerate(rows):
            t[:, i] = r
        return t

    def _rows_for_op(self, op: KeccakSpongeOp) -> list:
        """(keccak_sponge_stark.rs:210 generate_rows_for_op)"""
        rows = []
        state = np.zeros(50, np.uint64)
        data = op.input
        absorbed = 0
        while len(data) - absorbed >= KECCAK_RATE_BYTES:
            block = data[absorbed:absorbed + KECCAK_RATE_BYTES]
            row, state = self._common_row(op, absorbed, state, block)
            row[self.IS_FULL_INPUT_BLOCK] = 1
            rows.append(row)
            absorbed += KECCAK_RATE_BYTES
        final = data[absorbed:]
        # pad10*1 (keccak_sponge_stark.rs:276)
        block = bytearray(final) + bytearray(KECCAK_RATE_BYTES - len(final))
        if len(final) == KECCAK_RATE_BYTES - 1:
            block[len(final)] = 0b10000001
        else:
            block[len(final)] = 1
            block[KECCAK_RATE_BYTES - 1] = 0b10000000
        row, state = self._common_row(op, absorbed, state, bytes(block))
        row[self.IS_FINAL_INPUT_LEN[len(final)]] = 1
        rows.append(row)
        return rows

    def _common_row(self, op: KeccakSpongeOp, absorbed: int,
                    state: np.ndarray, block: bytes):
        """(keccak_sponge_stark.rs:295 generate_common_fields)"""
        row = np.zeros(self.COLUMNS, np.uint64)
        row[self.CONTEXT] = op.context
        row[self.SEGMENT] = op.segment
        row[self.VIRT] = op.virt
        row[self.TIMESTAMP] = op.timestamp
        row[self.LEN] = len(op.input)
        row[self.ALREADY_ABSORBED] = absorbed
        row[self.ORIGINAL_RATE.start:self.ORIGINAL_RATE.stop] = \
            state[:KECCAK_RATE_U32S]
        row[self.ORIGINAL_CAPACITY.start:self.ORIGINAL_CAPACITY.stop] = \
            state[KECCAK_RATE_U32S:]
        bb = np.frombuffer(block, np.uint8)
        row[self.BLOCK_BYTES.start:self.BLOCK_BYTES.stop] = bb
        block_u32 = bb.reshape(-1, 4).astype(np.uint64)
        block_u32 = (block_u32[:, 0] | (block_u32[:, 1] << U64(8))
                     | (block_u32[:, 2] << U64(16))
                     | (block_u32[:, 3] << U64(24)))
        xored = state.copy()
        xored[:KECCAK_RATE_U32S] ^= block_u32
        row[self.XORED_RATE.start:self.XORED_RATE.stop] = \
            xored[:KECCAK_RATE_U32S]
        new_state = keccakf_u32s(xored)
        row[self.UPDATED_STATE.start:self.UPDATED_STATE.stop] = new_state
        return row, new_state

    def hash_of(self, op: KeccakSpongeOp) -> bytes:
        """keccak256 digest implied by the final row's updated state."""
        rows = self._rows_for_op(op)
        out = rows[-1][self.UPDATED_STATE.start:self.UPDATED_STATE.start + 8]
        return b"".join(int(v).to_bytes(4, "little") for v in out)

    # ---- constraints (keccak_sponge_stark.rs:360 eval_packed_generic) --
    def eval_generic(self, ctx, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = ctx.one()

        is_full = lv[self.IS_FULL_INPUT_BLOCK]
        yield_constr.constraint(is_full * (is_full - one))
        finals = [lv[i] for i in self.IS_FINAL_INPUT_LEN]
        is_final = finals[0]
        for f in finals[1:]:
            is_final = is_final + f
        yield_constr.constraint(is_final * (is_final - one))
        for f in finals:
            yield_constr.constraint(f * (f - one))
        yield_constr.constraint(is_final * is_full)

        # first row starts a fresh op
        absorbed = lv[self.ALREADY_ABSORBED]
        yield_constr.constraint_first_row(absorbed)
        for i in list(self.ORIGINAL_RATE) + list(self.ORIGINAL_CAPACITY):
            yield_constr.constraint_first_row(lv[i])

        # a final block resets the next op's state
        yield_constr.constraint_transition(
            is_final * nv[self.ALREADY_ABSORBED])
        for i in list(self.ORIGINAL_RATE) + list(self.ORIGINAL_CAPACITY):
            yield_constr.constraint_transition(is_final * nv[i])

        # a full block continues the same op
        for i in (self.CONTEXT, self.SEGMENT, self.VIRT, self.TIMESTAMP,
                  self.LEN):
            yield_constr.constraint_transition(is_full * (lv[i] - nv[i]))
        for cur, nxt in zip(self.UPDATED_STATE,
                            list(self.ORIGINAL_RATE)
                            + list(self.ORIGINAL_CAPACITY)):
            yield_constr.constraint_transition(is_full * (nv[nxt] - lv[cur]))
        yield_constr.constraint_transition(
            is_full * (absorbed + ctx.constant(KECCAK_RATE_BYTES)
                       - nv[self.ALREADY_ABSORBED]))

        # dummy rows only at the end
        next_finals = [nv[i] for i in self.IS_FINAL_INPUT_LEN]
        next_is_final = next_finals[0]
        for f in next_finals[1:]:
            next_is_final = next_is_final + f
        is_dummy = one - is_full - is_final
        yield_constr.constraint_transition(
            is_dummy * (nv[self.IS_FULL_INPUT_BLOCK] + next_is_final))

        # final-length flag i implies len - already_absorbed == i
        offset = lv[self.LEN] - absorbed
        for i, f in enumerate(finals):
            yield_constr.constraint(f * (offset - ctx.constant(i)))

        # pad10*1 enforcement on the final block.  Pad bytes feed
        # XORED_RATE via the logic CTL but are excluded from the memory
        # CTL, so without these constraints a malicious prover could
        # absorb arbitrary padding and prove a wrong digest for a given
        # (addr, len).  With f_i the final-len flags and
        # s_j = sum_{i<j} f_i ("byte j lies strictly past the input
        # end"; linear in the flags), the pattern is pinned exactly:
        #   first pad byte:  f_j * (byte_j - 1) = 0            (j < 135)
        #                    f_135 * (byte_135 - 0x81) = 0     (1 | 0x80)
        #   interior zeros:  s_j * byte_j = 0             (1 <= j <= 134)
        #   closing byte:    s_135 * (byte_135 - 0x80) = 0
        bytes_ = [lv[i] for i in self.BLOCK_BYTES]
        last = KECCAK_RATE_BYTES - 1
        for j in range(last):
            yield_constr.constraint(finals[j] * (bytes_[j] - one))
        yield_constr.constraint(
            finals[last] * (bytes_[last] - ctx.constant(0x81)))
        s = ctx.zero()
        for j in range(1, last):
            s = s + finals[j - 1]
            yield_constr.constraint(s * bytes_[j])
        s = s + finals[last - 1]
        yield_constr.constraint(s * (bytes_[last] - ctx.constant(0x80)))

    def constraint_degree(self) -> int:
        return 3
