"""Sponge hashing over the Poseidon permutation.

Twin of reference plonky2/src/hash/hashing.rs: overwrite-mode absorption
(state[..k] = chunk, permute per rate-8 chunk), squeeze from the first 8
lanes; ``compress`` is the Merkle 2-to-1 (hashing.rs:98); ``hash_or_noop``
stores <= 4-element leaves raw, zero padded (plonk/config.rs:55).

Device functions are batched over leading axes; the ``_np`` versions are
host numpy for the verifier.  ``hash_no_pad`` (and ``hash_or_noop``
through it) sends a CUDA tensor to the fused sponge kernel
csrc/poseidon.cu poseidon_hash_rows (``hash_rows_cuda``: one launch per
batch of rows, the state in registers from the first chunk to the last)
and a CPU tensor to the plain version ``hash_no_pad_torch``, one
permutation per rate-8 chunk.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..field import gl64
from ..field.goldilocks import GF
from ..utils.cuda import CudaKernel, check_cuda_tensor
from .poseidon import permute, permute_np, permute_torch

SPONGE_RATE = 8
SPONGE_WIDTH = 12
NUM_HASH_OUT_ELTS = 4


HASH_ROWS = CudaKernel("poseidon.cu", "poseidon_hash_rows",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int])


# -- device (batched) -------------------------------------------------------

def hash_no_pad_torch(inputs: torch.Tensor,
                      num_outputs: int = NUM_HASH_OUT_ELTS) -> torch.Tensor:
    """Plain torch sponge on (rows, L) int64 rows -> (rows, num_outputs)."""
    state = torch.zeros(inputs.shape[0], SPONGE_WIDTH, dtype=torch.int64,
                        device=inputs.device)
    for start in range(0, inputs.shape[1], SPONGE_RATE):
        k = min(SPONGE_RATE, inputs.shape[1] - start)
        state = permute_torch(torch.cat([inputs[:, start:start + k],
                                         state[:, k:]], dim=1))
    return state[:, :num_outputs]


def hash_rows_cuda(inputs: torch.Tensor,
                   num_outputs: int = NUM_HASH_OUT_ELTS) -> torch.Tensor:
    """The sponge on the card through csrc/poseidon.cu poseidon_hash_rows:
    (rows, L) int64 rows, contiguous -> a new (rows, num_outputs) tensor.

    Replaces a loop of plonky2_tpu/ops/poseidon_pallas.py permute_cols
    launches, one per rate-8 chunk, with the slicing and concatenation
    between them: one launch keeps each row's state in registers."""
    check_cuda_tensor(inputs, "hash rows")
    if inputs.ndim != 2:
        raise ValueError(f"hash rows: expected (rows, L), got {tuple(inputs.shape)}")
    out = torch.empty(inputs.shape[0], num_outputs, dtype=torch.int64,
                      device=inputs.device)
    HASH_ROWS(inputs.data_ptr(), out.data_ptr(), inputs.shape[0],
              inputs.shape[1], num_outputs)
    return out


def hash_no_pad(inputs: GF, num_outputs: int = NUM_HASH_OUT_ELTS) -> GF:
    """Batched hash_n_to_m_no_pad: inputs (..., L) -> (..., num_outputs)."""
    if num_outputs > SPONGE_RATE:
        raise ValueError("multi-squeeze is not supported")
    batch = inputs.shape[:-1]
    rows = inputs.v.reshape(math.prod(batch), inputs.shape[-1])
    if rows.is_cuda:
        out = hash_rows_cuda(rows.contiguous(), num_outputs)
    else:
        out = hash_no_pad_torch(rows, num_outputs)
    return GF(out.reshape(*batch, num_outputs))


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
