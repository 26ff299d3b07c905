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
permutation per rate-8 chunk.  ``hash_no_pad_cols`` (and
``hash_or_noop_cols``) hash the columns of a (len, n) array, the layout in
which the LDE leaves a committed batch, optionally writing the digests in
Merkle leaf order (column reverse_bits(i) to row i): poseidon_hash_cols on
the card (``hash_cols_cuda``), the transpose and the plain sponge on the
CPU (``hash_cols_torch``).  Both kernels hash a leaf with one thread while
the leaves alone fill the card and with a group of 16 lanes of a warp
below that (``sponge_group``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..field import gl64
from ..field.goldilocks import GF
from ..utils.bits import log2_strict, reverse_index_bits_perm
from ..utils.cuda import CudaKernel, check_cuda_tensor
from .poseidon import permute, permute_np, permute_torch

SPONGE_RATE = 8
SPONGE_WIDTH = 12
NUM_HASH_OUT_ELTS = 4


HASH_ROWS = CudaKernel("poseidon.cu", "poseidon_hash_rows",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int, ctypes.c_int])
HASH_COLS = CudaKernel("poseidon.cu", "poseidon_hash_cols",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int])

# Lanes per leaf in the sponge kernels: one thread per leaf from
# GROUP_BELOW_LEAVES leaves up, where the leaves alone fill the card, and a
# group of SPONGE_GROUP lanes below (csrc/poseidon.cu's note; the cut-over is
# chip_smoke.py phase 3's measurement).
SPONGE_GROUP = 16
GROUP_BELOW_LEAVES = 1 << 14


def sponge_group(leaves: int) -> int:
    """Lanes that hash one leaf in a launch of ``leaves`` leaves."""
    return SPONGE_GROUP if leaves < GROUP_BELOW_LEAVES else 1


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


def hash_cols_torch(cols: torch.Tensor, num_outputs: int = NUM_HASH_OUT_ELTS,
                    leaf_order: bool = True) -> torch.Tensor:
    """Plain torch sponge of each column of a (L, n) int64 array -> (n,
    num_outputs), row i the digest of column reverse_bits(i) when
    leaf_order, else of column i."""
    rows = cols.transpose(0, 1)
    if leaf_order:
        perm = reverse_index_bits_perm(cols.shape[1])
        rows = rows[torch.as_tensor(perm, dtype=torch.int64, device=cols.device)]
    return hash_no_pad_torch(rows, num_outputs)


def hash_rows_cuda(inputs: torch.Tensor, num_outputs: int = NUM_HASH_OUT_ELTS,
                   group: int | None = None) -> torch.Tensor:
    """The sponge on the card through csrc/poseidon.cu poseidon_hash_rows:
    (rows, L) int64 rows, contiguous -> a new (rows, num_outputs) tensor;
    ``group`` lanes per row (1 or SPONGE_GROUP; sponge_group by default).

    Replaces a loop of plonky2_tpu/ops/poseidon_pallas.py permute_cols
    launches, one per rate-8 chunk, with the slicing and concatenation
    between them: one launch keeps each row's state on chip."""
    check_cuda_tensor(inputs, "hash rows")
    if inputs.ndim != 2:
        raise ValueError(f"hash rows: expected (rows, L), got {tuple(inputs.shape)}")
    rows = inputs.shape[0]
    out = torch.empty(rows, num_outputs, dtype=torch.int64, device=inputs.device)
    HASH_ROWS(inputs.data_ptr(), out.data_ptr(), rows, inputs.shape[1],
              num_outputs, group or sponge_group(rows))
    return out


def hash_cols_cuda(cols: torch.Tensor, num_outputs: int = NUM_HASH_OUT_ELTS,
                   leaf_order: bool = True,
                   group: int | None = None) -> torch.Tensor:
    """The sponge of each column of a (L, n) int64 CUDA array, rows
    contiguous (any row stride), through csrc/poseidon.cu
    poseidon_hash_cols -> a new (n, num_outputs) tensor in the order of
    hash_cols_torch."""
    if not cols.is_cuda:
        raise ValueError(f"hash cols: expected a CUDA tensor, got {cols.device}")
    if cols.dtype != torch.int64:
        raise ValueError(f"hash cols: expected int64, got {cols.dtype}")
    if cols.ndim != 2:
        raise ValueError(f"hash cols: expected (L, n), got {tuple(cols.shape)}")
    length, n = cols.shape
    if (n > 1 and cols.stride(1) != 1) or (length > 1 and cols.stride(0) < n):
        raise ValueError(f"hash cols: rows must be contiguous and apart, got "
                         f"strides {cols.stride()}")
    if leaf_order:
        log2_strict(n)
    out = torch.empty(n, num_outputs, dtype=torch.int64, device=cols.device)
    HASH_COLS(cols.data_ptr(), out.data_ptr(), length, n,
              cols.stride(0) if length > 1 else n, num_outputs,
              int(leaf_order), group or sponge_group(n))
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


def hash_no_pad_cols(cols: GF, num_outputs: int = NUM_HASH_OUT_ELTS,
                     leaf_order: bool = True) -> GF:
    """hash_no_pad of each column of a (L, n) batch -> (n, num_outputs), in
    leaf order (row i: column reverse_bits(i)) or in column order."""
    if num_outputs > SPONGE_RATE:
        raise ValueError("multi-squeeze is not supported")
    if cols.v.is_cuda:
        return GF(hash_cols_cuda(cols.v, num_outputs, leaf_order))
    return GF(hash_cols_torch(cols.v, num_outputs, leaf_order))


def hash_or_noop_cols(cols: GF, leaf_order: bool = True) -> GF:
    """hash_or_noop of each column of a (L, n) batch -> (n, 4), ordered as
    hash_no_pad_cols."""
    length = cols.shape[0]
    if length > NUM_HASH_OUT_ELTS:
        return hash_no_pad_cols(cols, NUM_HASH_OUT_ELTS, leaf_order)
    rows = cols.transpose(1, 0)
    if leaf_order:
        rows = rows.take(reverse_index_bits_perm(cols.shape[1]), axis=0)
    return hash_or_noop(rows)


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
