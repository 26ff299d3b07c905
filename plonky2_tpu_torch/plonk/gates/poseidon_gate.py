"""PoseidonGate: one full width-12 Poseidon permutation per row.

Twin of reference gates/poseidon.rs:29-200.  Wire layout (135 wires total):
inputs 0..12, outputs 12..24, swap 24, deltas 25..29, then the S-box inputs
of full rounds 1..3 (36), the 22 partial-round S-box inputs, and the S-box
inputs of the last 4 full rounds (48).

Constraints follow the *fast partial-round* schedule of the reference
(hash/poseidon.rs:584-610): after the first 4 full rounds, a fused constant
layer + initial matrix, then 22 rounds of (sbox lane 0, add constant, sparse
M' multiply).  The schedule is written once against operator-polymorphic
field elements, so the same code serves the prover's batched base-field
pass, the verifier's extension-scalar pass, and vectorised numpy witness
generation.
"""

from __future__ import annotations

import numpy as np

from ...field.gl64ext import V64, V64Ctx
from ...hash import poseidon_constants as C
from .. import targets
from .base import EvalVars, Gate, GeneratorSpec

WIDTH = C.SPONGE_WIDTH  # 12
HALF_FULL = C.HALF_N_FULL_ROUNDS  # 4
N_PARTIAL = C.N_PARTIAL_ROUNDS  # 22


# -- generic fast-schedule layers (reference hash/poseidon.rs) --------------

def constant_layer_g(ctx, state, round_ctr):
    return [state[i] + ctx.constant(C.ALL_ROUND_CONSTANTS[i + WIDTH * round_ctr])
            for i in range(WIDTH)]


def sbox_monomial_g(x):
    x2 = x * x
    x4 = x2 * x2
    x3 = x * x2
    return x3 * x4


def mds_layer_g(ctx, state):
    # Recursive-verifier contexts route full MDS layers through a dedicated
    # PoseidonMdsGate row (reference hash/poseidon.rs:284) instead of 144
    # scalar-mul/add gate slots.
    hook = getattr(ctx, "poseidon_mds_layer", None)
    if hook is not None:
        return hook(state)
    out = []
    for r in range(WIDTH):
        acc = state[r] * ctx.constant(C.MDS_MATRIX_DIAG[r]) if C.MDS_MATRIX_DIAG[r] else None
        for i in range(WIDTH):
            term = state[(i + r) % WIDTH] * ctx.constant(C.MDS_MATRIX_CIRC[i])
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def partial_first_constant_layer_g(ctx, state):
    return [state[i] + ctx.constant(C.FAST_PARTIAL_FIRST_ROUND_CONSTANT[i])
            for i in range(WIDTH)]


def mds_partial_layer_init_g(ctx, state):
    out = [state[0]] + [None] * (WIDTH - 1)
    for r in range(1, WIDTH):
        for c in range(1, WIDTH):
            t = ctx.constant(C.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1])
            term = state[r] * t
            out[c] = term if out[c] is None else out[c] + term
    return out


def mds_partial_layer_fast_g(ctx, state, r):
    mds0to0 = C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0]
    d = state[0] * ctx.constant(mds0to0)
    for i in range(1, WIDTH):
        d = d + state[i] * ctx.constant(C.FAST_PARTIAL_ROUND_W_HATS[r][i - 1])
    out = [d]
    for i in range(1, WIDTH):
        out.append(state[0] * ctx.constant(C.FAST_PARTIAL_ROUND_VS[r][i - 1]) + state[i])
    return out


def poseidon_fast_g(ctx, state):
    """Full permutation via the fast schedule — for consistency testing."""
    rc = 0
    for _ in range(HALF_FULL):
        state = constant_layer_g(ctx, state, rc)
        state = [sbox_monomial_g(s) for s in state]
        state = mds_layer_g(ctx, state)
        rc += 1
    state = partial_first_constant_layer_g(ctx, state)
    state = mds_partial_layer_init_g(ctx, state)
    for r in range(N_PARTIAL):
        state[0] = sbox_monomial_g(state[0])
        if r < N_PARTIAL - 1:
            state[0] = state[0] + ctx.constant(C.FAST_PARTIAL_ROUND_CONSTANTS[r])
        state = mds_partial_layer_fast_g(ctx, state, r)
    rc += N_PARTIAL
    for _ in range(HALF_FULL):
        state = constant_layer_g(ctx, state, rc)
        state = [sbox_monomial_g(s) for s in state]
        state = mds_layer_g(ctx, state)
        rc += 1
    return state


class PoseidonGate(Gate):
    WIRE_SWAP = 2 * WIDTH
    START_DELTA = 2 * WIDTH + 1
    START_FULL_0 = START_DELTA + 4
    START_PARTIAL = START_FULL_0 + WIDTH * (HALF_FULL - 1)
    START_FULL_1 = START_PARTIAL + N_PARTIAL

    @staticmethod
    def wire_input(i):
        return i

    @staticmethod
    def wire_output(i):
        return WIDTH + i

    @classmethod
    def wire_delta(cls, i):
        assert i < 4
        return cls.START_DELTA + i

    @classmethod
    def wire_full_sbox_0(cls, round_, i):
        assert 0 < round_ < HALF_FULL
        return cls.START_FULL_0 + WIDTH * (round_ - 1) + i

    @classmethod
    def wire_partial_sbox(cls, round_):
        return cls.START_PARTIAL + round_

    @classmethod
    def wire_full_sbox_1(cls, round_, i):
        return cls.START_FULL_1 + WIDTH * round_ + i

    @classmethod
    def end(cls):
        return cls.START_FULL_1 + WIDTH * HALF_FULL  # == 135

    def id(self) -> str:
        return "PoseidonGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH=12>"

    def num_wires(self) -> int:
        return self.end()

    def degree(self) -> int:
        return 7

    def num_constraints(self) -> int:
        return 1 + 4 + WIDTH * (HALF_FULL - 1) + N_PARTIAL + WIDTH * HALF_FULL + WIDTH

    def eval_unfiltered(self, ctx, vars: EvalVars) -> list:
        w = vars.local_wires
        constraints = []

        swap = w[self.WIRE_SWAP]
        constraints.append(swap * (swap - ctx.one()))
        for i in range(4):
            delta = w[self.wire_delta(i)]
            constraints.append(swap * (w[self.wire_input(i + 4)] - w[self.wire_input(i)]) - delta)

        # possibly-swapped input layer
        state = [None] * WIDTH
        for i in range(4):
            delta = w[self.wire_delta(i)]
            state[i] = w[self.wire_input(i)] + delta
            state[i + 4] = w[self.wire_input(i + 4)] - delta
        for i in range(8, WIDTH):
            state[i] = w[self.wire_input(i)]

        rc = 0
        for r in range(HALF_FULL):
            state = constant_layer_g(ctx, state, rc)
            if r != 0:
                for i in range(WIDTH):
                    sbox_in = w[self.wire_full_sbox_0(r, i)]
                    constraints.append(state[i] - sbox_in)
                    state[i] = sbox_in
            state = [sbox_monomial_g(s) for s in state]
            state = mds_layer_g(ctx, state)
            rc += 1

        state = partial_first_constant_layer_g(ctx, state)
        state = mds_partial_layer_init_g(ctx, state)
        for r in range(N_PARTIAL - 1):
            sbox_in = w[self.wire_partial_sbox(r)]
            constraints.append(state[0] - sbox_in)
            state[0] = sbox_monomial_g(sbox_in) + ctx.constant(C.FAST_PARTIAL_ROUND_CONSTANTS[r])
            state = mds_partial_layer_fast_g(ctx, state, r)
        sbox_in = w[self.wire_partial_sbox(N_PARTIAL - 1)]
        constraints.append(state[0] - sbox_in)
        state[0] = sbox_monomial_g(sbox_in)
        state = mds_partial_layer_fast_g(ctx, state, N_PARTIAL - 1)
        rc += N_PARTIAL

        for r in range(HALF_FULL):
            state = constant_layer_g(ctx, state, rc)
            for i in range(WIDTH):
                sbox_in = w[self.wire_full_sbox_1(r, i)]
                constraints.append(state[i] - sbox_in)
                state[i] = sbox_in
            state = [sbox_monomial_g(s) for s in state]
            state = mds_layer_g(ctx, state)
            rc += 1

        for i in range(WIDTH):
            constraints.append(state[i] - w[self.wire_output(i)])
        return constraints

    def generators(self, row: int, local_constants) -> list:
        deps = [targets.wire(row, self.wire_input(i)) for i in range(WIDTH)]
        deps.append(targets.wire(row, self.WIRE_SWAP))
        outs = poseidon_trace_wire_columns()
        return [GeneratorSpec(
            kind="poseidon",
            deps=deps,
            outs=[targets.wire(row, c) for c in outs],
            params=(),
        )]


def poseidon_trace_wire_columns() -> list:
    """Wire columns written by the Poseidon generator, in trace order."""
    cols = [PoseidonGate.wire_delta(i) for i in range(4)]
    for r in range(1, HALF_FULL):
        cols += [PoseidonGate.wire_full_sbox_0(r, i) for i in range(WIDTH)]
    cols += [PoseidonGate.wire_partial_sbox(r) for r in range(N_PARTIAL)]
    for r in range(HALF_FULL):
        cols += [PoseidonGate.wire_full_sbox_1(r, i) for i in range(WIDTH)]
    cols += [PoseidonGate.wire_output(i) for i in range(WIDTH)]
    return cols


def poseidon_generator_trace(dep_values: np.ndarray) -> np.ndarray:
    """Vectorised witness trace: dep_values (B, 13) = [12 inputs, swap] ->
    (B, len(trace columns)) wire values (reference gates/poseidon.rs generator).

    Small batches (sequential sponge chains level into 1-row groups) run
    on python ints (gl64ext.I64): numpy per-op overhead made the V64 path
    ~1 s per ROW, which dominated plonk witness generation wholesale
    (BASELINE.md round 5)."""
    from ...field.gl64ext import I64, I64Ctx
    B = dep_values.shape[0]
    # crossover: I64 ~5 ms/row flat; V64 ~1 s/group + ~3 ms/row
    if B <= 128:
        rows = []
        for b in range(B):
            out = _poseidon_trace_generic(
                I64Ctx(), [I64(int(dep_values[b, i])) for i in range(WIDTH)],
                I64(int(dep_values[b, WIDTH])))
            rows.append([v.v for v in out])
        return np.array(rows, dtype=np.uint64)
    out = _poseidon_trace_generic(
        V64Ctx(), [V64(dep_values[:, i]) for i in range(WIDTH)],
        V64(dep_values[:, WIDTH]))
    return np.stack([np.broadcast_to(v.v, dep_values[:, 0].shape)
                     for v in out], axis=1)


def _poseidon_trace_generic(ctx, inputs, swap) -> list:
    out = []

    deltas = []
    for i in range(4):
        d = swap * (inputs[i + 4] - inputs[i])
        deltas.append(d)
        out.append(d)

    state = [None] * WIDTH
    for i in range(4):
        state[i] = inputs[i] + deltas[i]
        state[i + 4] = inputs[i + 4] - deltas[i]
    for i in range(8, WIDTH):
        state[i] = inputs[i]

    rc = 0
    for r in range(HALF_FULL):
        state = constant_layer_g(ctx, state, rc)
        if r != 0:
            out.extend(state)  # sbox inputs for this round
        state = [sbox_monomial_g(s) for s in state]
        state = mds_layer_g(ctx, state)
        rc += 1

    state = partial_first_constant_layer_g(ctx, state)
    state = mds_partial_layer_init_g(ctx, state)
    for r in range(N_PARTIAL):
        out.append(state[0])  # partial sbox input
        state[0] = sbox_monomial_g(state[0])
        if r < N_PARTIAL - 1:
            state[0] = state[0] + ctx.constant(C.FAST_PARTIAL_ROUND_CONSTANTS[r])
        state = mds_partial_layer_fast_g(ctx, state, r)
    rc += N_PARTIAL

    for r in range(HALF_FULL):
        state = constant_layer_g(ctx, state, rc)
        out.extend(state)
        state = [sbox_monomial_g(s) for s in state]
        state = mds_layer_g(ctx, state)
        rc += 1

    out.extend(state)  # outputs
    return out
