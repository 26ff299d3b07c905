"""Keccak-f[1600] round STARK (twin of reference evm/src/keccak/).

One permutation occupies 24 consecutive rows, one round per row.  Round
state is bit-decomposed through the theta/rho/pi/chi/iota pipeline:

  columns (keccak/columns.rs):
    step flags s_0..s_23 | CTL filter | preimage (25 x 2 u32 limbs)
    | A (25 x 2 limbs) | C (5 x 64 bits) | C' (5 x 64 bits)
    | A' (25 x 64 bits) | A'' (25 x 2 limbs) | A''[0,0] bits (64)
    | A'''[0,0] (2 limbs)

  identities (keccak_stark.rs:244-420):
    C'[x,z]  = xor3(C[x,z], C[x-1,z], C[x+1,z-1])
    A limbs  = sum_z 2^z xor3(A'[x,y,z], C[x,z], C'[x,z])
    parity   : sum_y A'[x,y,z] - C'[x,z] in {0,2,4}
    A''[x,y] = sum_z 2^z xor(B[x,y,z], andn(B[x+1,y,z], B[x+2,y,z]))
               with B an alias (rho/pi rotation) of A'
    A'''[0,0]= A''[0,0] xor RC[round]   (bit-decomposed)
    next A   = A''' (within a permutation); preimage rows repeat.

XOR/ANDN are the degree-<=3 arithmetic generalisations x+y-2xy and
(1-x)y (keccak/logic.rs).  Trace generation is vectorised numpy u64
bit-twiddling over all requested permutations at once, replacing the
reference's per-row scalar loops (keccak_stark.rs:77-221).
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..stark.ctl import Column
from ..stark.stark import Stark

NUM_ROUNDS = 24
NUM_INPUTS = 25

# rho rotation offsets, R[x][y] (keccak/columns.rs:48)
R = [[0, 36, 3, 41, 18],
     [1, 44, 10, 45, 2],
     [62, 6, 43, 15, 61],
     [28, 55, 25, 21, 56],
     [27, 20, 39, 8, 14]]

# iota round constants (keccak/constants.rs)
RC = [0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
      0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
      0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
      0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
      0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
      0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
      0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
      0x8000000000008080, 0x0000000080000001, 0x8000000080008008]

U64 = np.uint64
MASK32 = np.uint64(0xFFFFFFFF)


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    n %= 64
    if n == 0:
        return v
    return (v << U64(n)) | (v >> U64(64 - n))


def keccak_f(state: np.ndarray) -> np.ndarray:
    """The permutation on a (P, 5, 5) u64 state indexed [perm, x, y]
    (delegates to the verified hash-layer kernel, which is [.., y, x])."""
    from ..hash.keccak import keccak_f as kf
    return kf(np.asarray(state, U64).swapaxes(-1, -2)).swapaxes(-1, -2)


class KeccakStark(Stark):
    PUBLIC_INPUTS = 0

    def __init__(self):
        self.REG_STEP = 0                      # ..NUM_ROUNDS
        self.REG_FILTER = NUM_ROUNDS
        start = NUM_ROUNDS + 1
        self.START_PREIMAGE = start
        start += 50
        self.START_A = start
        start += 50
        self.START_C = start
        start += 5 * 64
        self.START_C_PRIME = start
        start += 5 * 64
        self.START_A_PRIME = start
        start += 25 * 64
        self.START_A_PP = start
        start += 50
        self.START_A_PP_00_BITS = start
        start += 64
        self.A_PPP_00_LO = start
        self.A_PPP_00_HI = start + 1
        self.COLUMNS = start + 2

    # ---- register helpers (keccak/columns.rs) -------------------------
    def reg_preimage(self, x, y):
        return self.START_PREIMAGE + (x * 5 + y) * 2

    def reg_a(self, x, y):
        return self.START_A + (x * 5 + y) * 2

    def reg_c(self, x, z):
        return self.START_C + x * 64 + z

    def reg_c_prime(self, x, z):
        return self.START_C_PRIME + x * 64 + z

    def reg_a_prime(self, x, y, z):
        return self.START_A_PRIME + x * 64 * 5 + y * 64 + z

    def reg_b(self, x, y, z):
        """rho/pi alias into A' (columns.rs:100)."""
        a = (x + 3 * y) % 5
        b = x
        rot = R[a][b]
        return self.reg_a_prime(a, b, (z + 64 - rot) % 64)

    def reg_a_pp(self, x, y):
        return self.START_A_PP + (x * 5 + y) * 2

    def reg_a_ppp(self, x, y):
        if x == 0 and y == 0:
            return self.A_PPP_00_LO
        return self.reg_a_pp(x, y)

    # ---- CTL exports (keccak_stark.rs:35) -----------------------------
    def ctl_data(self) -> list:
        cols = []
        for i in range(2 * NUM_INPUTS):
            q, hi = divmod(i, 2)
            y, x = divmod(q, 5)
            cols.append(Column.single(self.reg_preimage(x, y) + hi))
        for i in range(2 * NUM_INPUTS):
            q, hi = divmod(i, 2)
            y, x = divmod(q, 5)
            cols.append(Column.single(self.reg_a_ppp(x, y) + hi))
        return cols

    def ctl_filter(self) -> Column:
        return Column.single(self.REG_FILTER)

    # ---- trace generation ---------------------------------------------
    def generate_trace(self, inputs: list, min_rows: int = 0) -> np.ndarray:
        """inputs: list of 25-element u64 state vectors (y-major order,
        input[y*5+x] as keccak_stark.rs:84).  Returns (COLUMNS, n) u64."""
        perms = np.zeros((max(1, len(inputs)), 5, 5), U64)
        for p, inp in enumerate(inputs):
            for i, v in enumerate(inp):
                y, x = divmod(i, 5)
                perms[p, x, y] = U64(v)
        if not inputs:
            # a single all-zero padding permutation
            pass
        rows = self._rows_for_perms(perms)
        if inputs:
            for p in range(len(inputs)):
                rows[p * NUM_ROUNDS + NUM_ROUNDS - 1, self.REG_FILTER] = 1
        n_real = len(inputs) * NUM_ROUNDS
        n = 1 << max(max(1, n_real, min_rows) - 1, 0).bit_length()
        trace_rows = np.zeros((n, self.COLUMNS), U64)
        trace_rows[:n_real] = rows[:n_real]
        if n > n_real:
            pad = self._rows_for_perms(np.zeros((1, 5, 5), U64))
            reps = -(-(n - n_real) // NUM_ROUNDS)
            trace_rows[n_real:] = np.tile(pad, (reps, 1))[:n - n_real]
        return np.ascontiguousarray(trace_rows.T)

    def _rows_for_perms(self, state: np.ndarray) -> np.ndarray:
        """(P*24, COLUMNS) u64 rows (keccak_stark.rs:77
        generate_trace_rows_for_perm, vectorised over perms)."""
        P_ = state.shape[0]
        rows = np.zeros((P_, NUM_ROUNDS, self.COLUMNS), U64)
        zpow = np.arange(64, dtype=U64)

        def put_bits(r, col_start, v):
            """v: (P,) u64 -> 64 bit columns starting at col_start."""
            rows[:, r, col_start:col_start + 64] = (v[:, None] >> zpow) & U64(1)

        def put_limbs(r, col, v):
            rows[:, r, col] = v & MASK32
            rows[:, r, col + 1] = v >> U64(32)

        preimage = state
        a = state.copy()
        for r in range(NUM_ROUNDS):
            rows[:, r, self.REG_STEP + r] = 1
            for x in range(5):
                for y in range(5):
                    put_limbs(r, self.reg_preimage(x, y), preimage[:, x, y])
                    put_limbs(r, self.reg_a(x, y), a[:, x, y])
            # theta
            c = np.stack([a[:, x, 0] ^ a[:, x, 1] ^ a[:, x, 2]
                          ^ a[:, x, 3] ^ a[:, x, 4] for x in range(5)], 1)
            c_prime = np.stack(
                [c[:, x] ^ c[:, (x + 4) % 5] ^ _rotl(c[:, (x + 1) % 5], 1)
                 for x in range(5)], 1)
            a_prime = np.empty_like(a)
            for x in range(5):
                put_bits(r, self.reg_c(x, 0), c[:, x])
                put_bits(r, self.reg_c_prime(x, 0), c_prime[:, x])
                for y in range(5):
                    a_prime[:, x, y] = a[:, x, y] ^ c[:, x] ^ c_prime[:, x]
                    put_bits(r, self.reg_a_prime(x, y, 0), a_prime[:, x, y])
            # rho/pi (B alias) + chi
            b = np.empty_like(a)
            for x in range(5):
                for y in range(5):
                    xa = (x + 3 * y) % 5
                    b[:, x, y] = _rotl(a_prime[:, xa, x], R[xa][x])
            a_pp = np.empty_like(a)
            for x in range(5):
                for y in range(5):
                    a_pp[:, x, y] = b[:, x, y] ^ (
                        ~b[:, (x + 1) % 5, y] & b[:, (x + 2) % 5, y])
                    put_limbs(r, self.reg_a_pp(x, y), a_pp[:, x, y])
            put_bits(r, self.START_A_PP_00_BITS, a_pp[:, 0, 0])
            # iota
            a_next = a_pp.copy()
            a_next[:, 0, 0] = a_pp[:, 0, 0] ^ U64(RC[r])
            put_limbs(r, self.A_PPP_00_LO, a_next[:, 0, 0])
            a = a_next
        return rows.reshape(P_ * NUM_ROUNDS, self.COLUMNS)

    # ---- constraints ---------------------------------------------------
    def eval_generic(self, ctx, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = ctx.one()
        two = ctx.constant(2)

        def xor_gen(x, y):
            return x + y - x * y * two

        def xor3_gen(x, y, z):
            return xor_gen(x, xor_gen(y, z))

        def andn_gen(x, y):
            return (one - x) * y

        # round flags (round_flags.rs:12): first row is round 0; flags
        # rotate by one each transition
        yield_constr.constraint_first_row(lv[self.REG_STEP] - one)
        for i in range(1, NUM_ROUNDS):
            yield_constr.constraint_first_row(lv[self.REG_STEP + i])
        for i in range(NUM_ROUNDS):
            yield_constr.constraint_transition(
                nv[self.REG_STEP + (i + 1) % NUM_ROUNDS]
                - lv[self.REG_STEP + i])

        filt = lv[self.REG_FILTER]
        yield_constr.constraint(filt * (filt - one))
        final_step = lv[self.REG_STEP + NUM_ROUNDS - 1]
        not_final = one - final_step
        yield_constr.constraint(not_final * filt)

        # preimage persists within a permutation
        for x in range(5):
            for y in range(5):
                for hi in (0, 1):
                    p = self.reg_preimage(x, y) + hi
                    yield_constr.constraint_transition(
                        not_final * (lv[p] - nv[p]))

        # C' = xor3(C[x], C[x-1], C[x+1] rot 1)
        for x in range(5):
            for z in range(64):
                xor = xor3_gen(lv[self.reg_c(x, z)],
                               lv[self.reg_c((x + 4) % 5, z)],
                               lv[self.reg_c((x + 1) % 5, (z + 63) % 64)])
                yield_constr.constraint(lv[self.reg_c_prime(x, z)] - xor)

        # A limbs match xor3(A', C, C') bits
        for x in range(5):
            for y in range(5):
                bits = [xor3_gen(lv[self.reg_a_prime(x, y, z)],
                                 lv[self.reg_c(x, z)],
                                 lv[self.reg_c_prime(x, z)])
                        for z in range(64)]
                self._check_limbs(ctx, yield_constr, bits,
                                  lv[self.reg_a(x, y)],
                                  lv[self.reg_a(x, y) + 1])

        # column parity: sum_y A'[x,y,z] - C'[x,z] in {0,2,4}
        four = ctx.constant(4)
        for x in range(5):
            for z in range(64):
                s = lv[self.reg_a_prime(x, 0, z)]
                for y in range(1, 5):
                    s = s + lv[self.reg_a_prime(x, y, z)]
                diff = s - lv[self.reg_c_prime(x, z)]
                yield_constr.constraint(diff * (diff - two) * (diff - four))

        # A'' limbs = chi over B bits
        for x in range(5):
            for y in range(5):
                bits = [xor_gen(lv[self.reg_b(x, y, z)],
                                andn_gen(lv[self.reg_b((x + 1) % 5, y, z)],
                                         lv[self.reg_b((x + 2) % 5, y, z)]))
                        for z in range(64)]
                self._check_limbs(ctx, yield_constr, bits,
                                  lv[self.reg_a_pp(x, y)],
                                  lv[self.reg_a_pp(x, y) + 1])

        # A''[0,0] bit decomposition
        bits00 = [lv[self.START_A_PP_00_BITS + z] for z in range(64)]
        self._check_limbs(ctx, yield_constr, bits00, lv[self.reg_a_pp(0, 0)],
                          lv[self.reg_a_pp(0, 0) + 1])

        # iota: A'''[0,0] = A''[0,0] xor RC[round]
        def xored_bit(i):
            rc_bit = ctx.zero()
            for r in range(NUM_ROUNDS):
                if (RC[r] >> i) & 1:
                    rc_bit = rc_bit + lv[self.REG_STEP + r]
            return xor_gen(bits00[i], rc_bit)

        self._check_limbs(ctx, yield_constr,
                          [xored_bit(z) for z in range(64)],
                          lv[self.A_PPP_00_LO], lv[self.A_PPP_00_HI])

        # output feeds the next round's input within a permutation
        for x in range(5):
            for y in range(5):
                for hi in (0, 1):
                    out = lv[self.reg_a_ppp(x, y) + hi]
                    inp = nv[self.reg_a(x, y) + hi]
                    yield_constr.constraint_transition(
                        not_final * (out - inp))

    def _check_limbs(self, ctx, yield_constr, bits, lo, hi) -> None:
        """sum_z 2^z bits[z] must equal the (lo, hi) u32 limb pair."""
        comp_lo = ctx.zero()
        comp_hi = ctx.zero()
        for z in range(31, -1, -1):
            comp_lo = comp_lo + comp_lo + bits[z]
            comp_hi = comp_hi + comp_hi + bits[z + 32]
        yield_constr.constraint(comp_lo - lo)
        yield_constr.constraint(comp_hi - hi)

    def constraint_degree(self) -> int:
        return 3
