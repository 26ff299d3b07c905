"""Poseidon permutation over Goldilocks, width 12, on torch.

The canonical round schedule of the reference (plonky2/src/hash/poseidon.rs
574-636): 4 full rounds, 22 partial rounds (S-box on lane 0 only), 4 full
rounds; every round is constant layer -> x^7 S-box -> circulant+diagonal
MDS.  MDS sums accumulate exactly on the 32-bit halves of each lane and are
reduced once per output (the reference's u128 trick, poseidon.rs:178).

``permute`` sends a CUDA tensor to the hand-written kernel csrc/poseidon.cu
(``permute_cuda``, which runs the partial rounds in the reference's fast
schedule, poseidon.rs:584: the same permutation) and a CPU tensor to the
plain torch version ``permute_torch``.  ``permute_np`` is the host numpy twin for the challenger.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..field import gl64
from ..field.goldilocks import GF, add, mul, reduce128, srl32, ult
from ..utils.cuda import CudaKernel, check_cuda_tensor
from . import poseidon_constants as C

WIDTH = 12
_MASK32 = np.uint64(0xFFFFFFFF)
_RC_NP = np.array(C.ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(C.N_ROUNDS, WIDTH)

POSEIDON = CudaKernel("poseidon.cu", "poseidon_permute",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64])


def _mds_matrix() -> np.ndarray:
    """M[r, (r + i) % 12] = CIRC[i], plus DIAG on the diagonal."""
    m = np.zeros((WIDTH, WIDTH), dtype=np.int64)
    for r in range(WIDTH):
        for i, c in enumerate(C.MDS_MATRIX_CIRC):
            m[r, (r + i) % WIDTH] += c
        m[r, r] += C.MDS_MATRIX_DIAG[r]
    return m


_MDS = _mds_matrix()
_MDS_T_NP = _MDS.T.astype(np.uint64)


def _sbox(x: torch.Tensor) -> torch.Tensor:
    """x^7 = x^3 * x^4."""
    x2 = mul(x, x)
    x4 = mul(x2, x2)
    return mul(mul(x, x2), x4)


def _mds(s: torch.Tensor, mt: torch.Tensor) -> torch.Tensor:
    """(B, 12) -> (B, 12), mt = M^T in float64.  The 32-bit halves of the
    lanes go through one float64 matrix product: every product is < 2^38
    and every sum < 13 * 41 * 2^32 < 2^42, integers that float64 holds
    exactly whatever the summation order."""
    halves = torch.stack([s & 0xFFFFFFFF, srl32(s)]).double()
    col = (halves @ mt).long()
    col_lo, col_hi = col[0], col[1]
    lo64 = col_lo + (col_hi << 32)             # wraps mod 2^64
    hi64 = srl32(col_hi) + ult(lo64, col_lo).long()
    return reduce128(hi64, lo64)


def permute_torch(states: torch.Tensor) -> torch.Tensor:
    """Plain torch Poseidon on (B, 12) int64 states (noncanonical in/out)."""
    dev = states.device
    rc = torch.from_numpy(_RC_NP.view(np.int64)).to(dev)
    m = torch.from_numpy(_MDS.T.astype(np.float64)).to(dev)
    s = states
    r = 0
    for _ in range(C.HALF_N_FULL_ROUNDS):
        s = _mds(_sbox(add(s, rc[r])), m)
        r += 1
    for _ in range(C.N_PARTIAL_ROUNDS):
        s = add(s, rc[r])
        s = torch.cat([_sbox(s[:, :1]), s[:, 1:]], dim=1)
        s = _mds(s, m)
        r += 1
    for _ in range(C.HALF_N_FULL_ROUNDS):
        s = _mds(_sbox(add(s, rc[r])), m)
        r += 1
    return s


def permute_cuda(states: torch.Tensor) -> torch.Tensor:
    """Poseidon on the card through csrc/poseidon.cu: (B, 12) int64 states,
    contiguous; returns a new (B, 12) tensor.

    Replaces the TPU kernel plonky2_tpu/ops/poseidon_pallas.py permute_cols.
    On the H100 it is bound by integer multiplies and the instructions
    around them (192 bytes of state per 6,272 32-bit multiplies); the
    kernel keeps each state in one thread's registers, runs the partial
    rounds in the reference's fast schedule and the constants from
    __constant__ memory."""
    check_cuda_tensor(states, "poseidon states")
    if states.ndim != 2 or states.shape[1] != WIDTH:
        raise ValueError(f"poseidon states: expected (B, 12), got {tuple(states.shape)}")
    out = torch.empty_like(states)
    POSEIDON(states.data_ptr(), out.data_ptr(), states.shape[0])
    return out


def permute(state: GF) -> GF:
    """Full 30-round Poseidon on a (..., 12) GF state: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"poseidon state width {state.shape[-1]} != 12")
    batch = state.shape[:-1]
    flat = state.v.reshape(-1, WIDTH)
    if flat.is_cuda:
        out = permute_cuda(flat.contiguous())
    else:
        out = permute_torch(flat)
    return GF(out.reshape(*batch, WIDTH))


# ---------------------------------------------------------------------------
# Host (numpy u64) twin — the challenger's duplex.
# ---------------------------------------------------------------------------

def _sbox_np(x):
    x2 = gl64.mul(x, x)
    x4 = gl64.mul(x2, x2)
    return gl64.mul(gl64.mul(x, x2), x4)


def _mds_np(state):
    """state: (..., 12) u64.  Exact accumulation on u32 half-limbs (sums
    < 13 * 41 * 2^32 < 2^42), one integer matrix product per half."""
    with np.errstate(over="ignore"):
        col_lo = (state & _MASK32) @ _MDS_T_NP
        col_hi = (state >> np.uint64(32)) @ _MDS_T_NP
        lo = col_lo + (col_hi << np.uint64(32))
        carry = lo < col_lo
        hi = (col_hi >> np.uint64(32)) + carry
        return gl64.reduce128(hi, lo)


def permute_np(state: np.ndarray) -> np.ndarray:
    """Host Poseidon on (..., 12) u64 arrays (noncanonical in/out)."""
    state = np.asarray(state, dtype=np.uint64)
    if state.shape[-1] != WIDTH:
        raise ValueError(f"poseidon state width {state.shape[-1]} != 12")
    r = 0
    for _ in range(C.HALF_N_FULL_ROUNDS):
        state = _mds_np(_sbox_np(gl64.add(state, _RC_NP[r])))
        r += 1
    for _ in range(C.N_PARTIAL_ROUNDS):
        state = gl64.add(state, _RC_NP[r]).copy()
        state[..., 0] = _sbox_np(state[..., 0])
        state = _mds_np(state)
        r += 1
    for _ in range(C.HALF_N_FULL_ROUNDS):
        state = _mds_np(_sbox_np(gl64.add(state, _RC_NP[r])))
        r += 1
    return state
