"""Sponge hashing over the Poseidon permutation.

Twin of reference plonky2/src/hash/hashing.rs: overwrite-mode absorption
(state[..k] = chunk, permute per rate-8 chunk), squeeze from the first 8
lanes; ``compress`` is the Merkle 2-to-1 (hashing.rs:98); ``hash_or_noop``
stores <= 4-element leaves raw, zero padded (plonk/config.rs:55).

Device functions are batched over leading axes; the ``_np`` versions are
host numpy for the verifier.
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..field.goldilocks import GF
from .poseidon import permute, permute_np

SPONGE_RATE = 8
SPONGE_WIDTH = 12
NUM_HASH_OUT_ELTS = 4


# -- device (batched) -------------------------------------------------------

def hash_no_pad(inputs: GF, num_outputs: int = NUM_HASH_OUT_ELTS) -> GF:
    """Batched hash_n_to_m_no_pad: inputs (..., L) -> (..., num_outputs)."""
    if num_outputs > SPONGE_RATE:
        raise ValueError("multi-squeeze is not supported")
    batch = inputs.shape[:-1]
    length = inputs.shape[-1]
    state = GF.zeros(batch + (SPONGE_WIDTH,), inputs.device)
    for start in range(0, length, SPONGE_RATE):
        k = min(SPONGE_RATE, length - start)
        chunk = inputs[..., start:start + k]
        state = permute(GF.concatenate([chunk, state[..., k:]], axis=-1))
    return state[..., :num_outputs]


def hash_or_noop(inputs: GF) -> GF:
    """(..., L) -> (..., 4): raw zero-padded if L <= 4, else sponge hash."""
    length = inputs.shape[-1]
    if length <= NUM_HASH_OUT_ELTS:
        pad = GF.zeros(inputs.shape[:-1] + (NUM_HASH_OUT_ELTS - length,),
                       inputs.device)
        return GF.concatenate([inputs, pad], axis=-1)
    return hash_no_pad(inputs)


def compress(x: GF, y: GF) -> GF:
    """Batched 2-to-1: (..., 4), (..., 4) -> (..., 4)."""
    zeros = GF.zeros(x.shape[:-1] + (SPONGE_WIDTH - 8,), x.device)
    state = GF.concatenate([x, y, zeros], axis=-1)
    return permute(state)[..., :NUM_HASH_OUT_ELTS]


# -- host (numpy u64) --------------------------------------------------------

def hash_no_pad_np(inputs: np.ndarray, num_outputs: int = NUM_HASH_OUT_ELTS) -> np.ndarray:
    inputs = np.asarray(inputs, dtype=np.uint64)
    batch, length = inputs.shape[:-1], inputs.shape[-1]
    state = np.zeros(batch + (SPONGE_WIDTH,), dtype=np.uint64)
    for start in range(0, length, SPONGE_RATE):
        k = min(SPONGE_RATE, length - start)
        state[..., :k] = inputs[..., start:start + k]
        state = permute_np(state)
    return gl64.to_canonical(state[..., :num_outputs])


def hash_or_noop_np(inputs: np.ndarray) -> np.ndarray:
    inputs = np.asarray(inputs, dtype=np.uint64)
    length = inputs.shape[-1]
    if length <= NUM_HASH_OUT_ELTS:
        pad = np.zeros(inputs.shape[:-1] + (NUM_HASH_OUT_ELTS - length,),
                       dtype=np.uint64)
        return gl64.to_canonical(np.concatenate([inputs, pad], axis=-1))
    return hash_no_pad_np(inputs)


def compress_np(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    state = np.zeros(x.shape[:-1] + (SPONGE_WIDTH,), dtype=np.uint64)
    state[..., 0:4] = x
    state[..., 4:8] = y
    return gl64.to_canonical(permute_np(state)[..., :NUM_HASH_OUT_ELTS])
