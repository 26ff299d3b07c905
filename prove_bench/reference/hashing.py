"""Poseidon over Goldilocks (width 12, x^7) and the sponge, Merkle and
compression functions built on it, in plain numpy.

The permutation is written from the published round structure (reference
plonky2/src/hash/poseidon.rs): 4 full rounds, 22 partial rounds, 4 full
rounds, each a constant layer, an S-box layer and the circulant MDS
layer.  It runs the plain schedule, not the fast partial-round schedule the
program's kernels use, so the two agree only if both are right.
"""

from __future__ import annotations

import numpy as np

from . import gl64
from . import poseidon_constants as C

WIDTH = C.SPONGE_WIDTH
RATE = C.SPONGE_RATE
NUM_HASH_OUT_ELTS = 4

_RC = np.array(C.ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(C.N_ROUNDS, WIDTH)
# MDS[r][c]: output lane r takes input lane c with CIRC[(c - r) % 12], plus
# DIAG[r] on the diagonal
_MDS = [[C.MDS_MATRIX_CIRC[(c - r) % WIDTH] + (C.MDS_MATRIX_DIAG[r] if r == c else 0)
         for c in range(WIDTH)] for r in range(WIDTH)]


def _sbox(x: np.ndarray) -> np.ndarray:
    x2 = gl64.mul(x, x)
    x3 = gl64.mul(x2, x)
    x4 = gl64.mul(x2, x2)
    return gl64.mul(x3, x4)


_MDS_T = np.array(_MDS, dtype=np.uint64).T.copy()
_MASK32 = np.uint64(0xFFFFFFFF)


def _mds(state: np.ndarray) -> np.ndarray:
    """The MDS product, exact on 32-bit halves: each half's column sums
    stay below 12 * 41 * 2^32 < 2^42, so one integer matrix product per
    half, then the 128-bit recombination and one reduction."""
    with np.errstate(over="ignore"):
        col_lo = (state & _MASK32) @ _MDS_T
        col_hi = (state >> np.uint64(32)) @ _MDS_T
        lo = col_lo + (col_hi << np.uint64(32))
        carry = (lo < col_lo).astype(np.uint64)
        hi = (col_hi >> np.uint64(32)) + carry
    return gl64.reduce128(hi, lo)


_P = gl64.ORDER_INT
_RC_INT = [[int(c) for c in row] for row in _RC]


def _permute_int(s: list) -> list:
    """One state on Python integers: a single state costs numpy more in
    per-call overhead than in arithmetic."""
    half = C.HALF_N_FULL_ROUNDS
    for r in range(C.N_ROUNDS):
        s = [(x + c) % _P for x, c in zip(s, _RC_INT[r])]
        if half <= r < half + C.N_PARTIAL_ROUNDS:
            s[0] = pow(s[0], 7, _P)
        else:
            s = [pow(x, 7, _P) for x in s]
        s = [sum(m * x for m, x in zip(row, s)) % _P for row in _MDS]
    return s


def permute(state: np.ndarray) -> np.ndarray:
    """Poseidon on (..., 12) u64 states; canonical output."""
    state = np.asarray(state, dtype=np.uint64)
    if state.shape[-1] != WIDTH:
        raise ValueError(f"a Poseidon state has 12 elements, not {state.shape[-1]}")
    if state.ndim == 1:
        return np.array(_permute_int([int(x) for x in state]), dtype=np.uint64)
    half = C.HALF_N_FULL_ROUNDS
    for r in range(C.N_ROUNDS):
        state = gl64.add(state, _RC[r])
        if half <= r < half + C.N_PARTIAL_ROUNDS:
            state = state.copy()
            state[..., 0] = _sbox(state[..., 0])
        else:
            state = _sbox(state)
        state = _mds(state)
    return gl64.to_canonical(state)


def hash_no_pad(inputs: np.ndarray, num_outputs: int = NUM_HASH_OUT_ELTS) -> np.ndarray:
    """The overwrite-mode sponge of (..., L) inputs, no padding."""
    inputs = np.asarray(inputs, dtype=np.uint64)
    state = np.zeros(inputs.shape[:-1] + (WIDTH,), dtype=np.uint64)
    for start in range(0, inputs.shape[-1], RATE):
        k = min(RATE, inputs.shape[-1] - start)
        state[..., :k] = inputs[..., start:start + k]
        state = permute(state)
    return gl64.to_canonical(state[..., :num_outputs])


def hash_or_noop(inputs: np.ndarray) -> np.ndarray:
    """Leaves of at most 4 elements are their own digest (zero padded)."""
    inputs = gl64.to_canonical(np.asarray(inputs, dtype=np.uint64))
    length = inputs.shape[-1]
    if length <= NUM_HASH_OUT_ELTS:
        pad = np.zeros(inputs.shape[:-1] + (NUM_HASH_OUT_ELTS - length,), np.uint64)
        return np.concatenate([inputs, pad], axis=-1)
    return hash_no_pad(inputs)


def compress(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    state = np.zeros(np.shape(x)[:-1] + (WIDTH,), dtype=np.uint64)
    state[..., 0:4] = x
    state[..., 4:8] = y
    return permute(state)[..., :NUM_HASH_OUT_ELTS]


def verify_merkle_paths(leaves: np.ndarray, indices: np.ndarray,
                        cap: np.ndarray, siblings: np.ndarray) -> bool:
    """q Merkle paths at once: leaves (q, L), leaf indices (q,), siblings
    (q, depth, 4), into a cap (2^h, 4)."""
    current = hash_or_noop(leaves)
    idx = np.asarray(indices, dtype=np.int64)
    siblings = np.asarray(siblings, dtype=np.uint64)
    for d in range(siblings.shape[1]):
        right = (idx & 1).astype(bool)[:, None]
        sib = siblings[:, d]
        current = compress(np.where(right, sib, current),
                           np.where(right, current, sib))
        idx = idx >> 1
    return bool(np.array_equal(current, gl64.to_canonical(np.asarray(cap)[idx])))


class Challenger:
    """The Fiat-Shamir duplex over the permutation (reference
    iop/challenger.rs)."""

    def __init__(self):
        self.state = np.zeros(WIDTH, dtype=np.uint64)
        self.inputs: list[int] = []
        self.outputs: list[int] = []

    def observe_element(self, x) -> None:
        self.outputs.clear()
        self.inputs.append(int(x) % gl64.ORDER_INT)
        if len(self.inputs) == RATE:
            self._duplex()

    def observe_elements(self, xs) -> None:
        for x in np.asarray(xs, dtype=np.uint64).reshape(-1):
            self.observe_element(x)

    def observe_cap(self, cap) -> None:
        self.observe_elements(np.asarray(cap, dtype=np.uint64).reshape(-1))

    def get_challenge(self) -> int:
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def get_n_challenges(self, n: int) -> list:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> np.ndarray:
        return np.array(self.get_n_challenges(2), dtype=np.uint64)

    def _duplex(self) -> None:
        if self.inputs:
            self.state = self.state.copy()
            self.state[:len(self.inputs)] = self.inputs
            self.inputs = []
        self.state = permute(self.state)
        self.outputs = [int(x) for x in self.state[:RATE]]
