"""Fiat-Shamir challenger: duplex sponge in overwrite mode.

Host twin of reference plonky2/src/iop/challenger.rs:16-160, and its
circuit twin ``RecursiveChallenger`` (challenger.rs:164).  Challenges
drive host-side control flow (query indices, PoW checks), so the challenger
runs on numpy u64; each duplex is one width-12 Poseidon permutation, or
under the keccak config the keccak hash onion of keccak.rs:64
(hash/keccak_tree.py), with the same overwrite-mode schedule.

Transcript-order details that matter for byte-compat with the reference:
  * absorption auto-duplexes when the input buffer reaches RATE=8;
  * ``get_challenge`` duplexes if inputs are pending or outputs exhausted;
  * outputs are state[0..8] and are popped from the END (Vec::pop), so
    challenges stream as state[7], state[6], ..., state[0].
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..hash.keccak_tree import bytes_hash_to_felts, keccak_permutation_np
from ..hash.poseidon import permute_np

RATE = 8
WIDTH = 12


def permutation_for(hasher: str):
    """The challenger duplex core of a hasher config (plonk/config.rs:28)."""
    if hasher == "keccak":
        return keccak_permutation_np
    return permute_np


class Challenger:
    def __init__(self, permutation=None):
        self.state = np.zeros(WIDTH, dtype=np.uint64)
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []
        self._permute = permutation or permute_np

    # -- observe -----------------------------------------------------------
    def observe_element(self, x) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(int(x) % gl64.ORDER_INT)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_elements(self, xs) -> None:
        for x in np.asarray(xs, dtype=np.uint64).reshape(-1):
            self.observe_element(x)

    def observe_extension_element(self, x) -> None:
        """x: (2,) base-field array for D=2."""
        self.observe_elements(np.asarray(x, dtype=np.uint64))

    def observe_hash(self, h) -> None:
        h = np.asarray(h)
        if h.dtype == np.uint8:
            # byte digest (BytesHash::to_vec, hash_types.rs:181)
            self.observe_elements(bytes_hash_to_felts(h).reshape(-1))
        else:
            self.observe_elements(h.astype(np.uint64).reshape(4))

    def observe_cap(self, cap) -> None:
        data = np.asarray(cap.data if hasattr(cap, "data") else cap)
        if data.dtype != np.uint8:
            data = data.astype(np.uint64).reshape(-1, 4)
        for row in data:
            self.observe_hash(row)

    # -- squeeze -----------------------------------------------------------
    def get_challenge(self) -> np.uint64:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return np.uint64(self.output_buffer.pop())

    def get_n_challenges(self, n: int) -> np.ndarray:
        return np.array([self.get_challenge() for _ in range(n)], dtype=np.uint64)

    def get_extension_challenge(self) -> np.ndarray:
        """(2,) base-field components of one GF(p^2) challenge."""
        return self.get_n_challenges(2)

    # -- state snapshots (challenger.rs compact) ----------------------------
    def compact(self) -> np.ndarray:
        """Absorb pending inputs and return the 12-felt sponge state."""
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return self.state.copy()

    # -- internals -----------------------------------------------------------
    def _duplexing(self) -> None:
        k = len(self.input_buffer)
        if k:
            self.state = self.state.copy()
            self.state[:k] = np.array(self.input_buffer, dtype=np.uint64)
            self.input_buffer.clear()
        self.state = self._permute(self.state)
        self.output_buffer = [int(x) for x in gl64.to_canonical(self.state[:RATE])]


class RecursiveChallenger:
    """Circuit twin of ``Challenger`` (reference iop/challenger.rs:164): the
    same duplex schedule over targets, each permutation one PoseidonGate
    row."""

    def __init__(self, builder):
        self.b = builder
        zero = builder.zero()
        self.state = [zero] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observe -------------------------------------------------------------
    def observe_element(self, t: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(t)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_elements(self, ts) -> None:
        for t in ts:
            self.observe_element(t)

    def observe_extension_element(self, et: tuple) -> None:
        self.observe_elements(et)

    def observe_hash(self, h: list) -> None:
        self.observe_elements(h)

    def observe_cap(self, cap: list) -> None:
        for h in cap:
            self.observe_hash(h)

    # -- squeeze -------------------------------------------------------------
    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self) -> list:
        return self.get_n_challenges(4)

    def get_extension_challenge(self) -> tuple:
        return tuple(self.get_n_challenges(2))

    # -- state snapshots ------------------------------------------------------
    def compact(self) -> list:
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return list(self.state)

    @staticmethod
    def from_state(builder, state: list) -> "RecursiveChallenger":
        ch = RecursiveChallenger(builder)
        ch.state = list(state)
        return ch

    # -- internals -------------------------------------------------------------
    def _duplexing(self) -> None:
        assert len(self.input_buffer) <= RATE
        for i, t in enumerate(self.input_buffer):
            self.state[i] = t
        self.input_buffer.clear()
        false_t = self.b.zero()
        self.state = self.b.permute_swapped(self.state, false_t)
        self.output_buffer = list(self.state[:RATE])
