"""Number-theoretic transform over Goldilocks on torch.

Twin of reference field/src/fft.rs:52,99,169: a radix-2 DIT on bit-reversed
input, one vectorised torch pass per stage over a (batch..., n) GF array.
Twiddles come from one table per (log n, direction, device), tw[i] = w_n^i
for i < n/2; stage s uses every (n / 2^s)-th entry.

``lde`` is the commitment LDE.  A CUDA tensor goes to the hand-written
kernel csrc/lde.cu (``lde_cuda``); a CPU tensor to the plain torch version
``lde_torch``.  Extension (GF2) codewords transform componentwise.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils.bits import log2_strict, reverse_index_bits_perm
from ..utils.cuda import CudaKernel, check_cuda_tensor
from . import gl64
from .extension import GF2
from .goldilocks import GF, add, mul, sub

COSET_LDE = CudaKernel("lde.cu", "coset_lde", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int])


@lru_cache(maxsize=32)
def _twiddle_table(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """tw[i] = w^i for i < n/2, w the (inverse) primitive n-th root."""
    root = gl64.primitive_root_of_unity(log_n)
    if inverse:
        root = pow(root, gl64.ORDER_INT - 2, gl64.ORDER_INT)
    tw = gl64.powers(root, max((1 << log_n) >> 1, 1))
    return torch.from_numpy(tw.view(np.int64).copy()).to(device)


@lru_cache(maxsize=32)
def _coset_table(shift: int, n: int, device: torch.device) -> torch.Tensor:
    """[shift^0, ..., shift^(n-1)]."""
    return torch.from_numpy(gl64.powers(shift, n).view(np.int64).copy()).to(device)


@lru_cache(maxsize=32)
def _brp(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(reverse_index_bits_perm(n).astype(np.int64)).to(device)


def _n_inv(n: int) -> int:
    return pow(n, gl64.ORDER_INT - 2, gl64.ORDER_INT)


def ntt_br(x: GF, start_stage: int = 0, inverse: bool = False) -> GF:
    """DIT butterflies on a bit-reversed-order input along the last axis,
    from stage start_stage + 1 (earlier stages are taken as done)."""
    n = x.shape[-1]
    log_n = log2_strict(n)
    tw = _twiddle_table(log_n, inverse, x.device)
    batch = x.shape[:-1]
    v = x.v
    for s in range(start_stage + 1, log_n + 1):
        half = 1 << (s - 1)
        vr = v.reshape(*batch, n >> s, 2, half)
        t = mul(vr[..., 1, :], tw[:: n >> s][:half])
        a = vr[..., 0, :]
        v = torch.stack([add(a, t), sub(a, t)], dim=-2).reshape(*batch, n)
    return GF(v)


def ntt(coeffs: GF) -> GF:
    """values[i] = poly(g^i) over the order-n subgroup, natural order."""
    n = coeffs.shape[-1]
    return ntt_br(coeffs.take(_brp(n, coeffs.device), axis=-1))


def intt(values: GF) -> GF:
    """Inverse NTT: values over the subgroup -> coefficients."""
    n = values.shape[-1]
    out = ntt_br(values.take(_brp(n, values.device), axis=-1), inverse=True)
    return out * _n_inv(n)


def coset_ntt(coeffs: GF, shift: int) -> GF:
    """Evaluate on the coset shift*H (reference polynomial/mod.rs coset_fft)."""
    n = coeffs.shape[-1]
    return ntt(GF(mul(coeffs.v, _coset_table(shift, n, coeffs.device))))


def coset_intt(values: GF, shift: int) -> GF:
    """Inverse of coset_ntt."""
    n = values.shape[-1]
    shift_inv = pow(shift, gl64.ORDER_INT - 2, gl64.ORDER_INT)
    return GF(mul(intt(values).v, _coset_table(shift_inv, n, values.device)))


def lde_torch(coeffs: GF, rate_bits: int, shift: int = 1) -> GF:
    """Plain torch LDE: evaluate degree<n coeffs (..., n) on the 2^rate_bits
    larger coset shift*H, skipping the first rate_bits butterfly stages
    (reference fft.rs:169 stage skip for zero-padded input)."""
    n = coeffs.shape[-1]
    v = coeffs.v
    if shift != 1:
        v = mul(v, _coset_table(shift, n, v.device))
    v = torch.index_select(v, -1 % v.ndim, _brp(n, v.device))
    v = torch.repeat_interleave(v, 1 << rate_bits, dim=-1)
    return ntt_br(GF(v), start_stage=rate_bits)


def lde_cuda(coeffs: GF, rate_bits: int, shift: int = 1) -> GF:
    """The LDE on the card through csrc/lde.cu, same contract as lde_torch.

    Replaces the TPU kernel plonky2_tpu/ops/mxu_lde_pallas.py mxu_lde.  On
    the H100 it is bound by moving its input and output once, with the
    integer multiplies of its butterflies close behind; the kernel runs the
    first stages in a shared-memory tile and each later stage as one pass
    over device memory."""
    x = coeffs.v
    check_cuda_tensor(x, "lde coeffs")
    n = x.shape[-1]
    log_n = log2_strict(n)
    batch = x.shape[:-1]
    k = int(np.prod(batch)) if batch else 1
    if k > 65535:
        raise ValueError(f"lde: {k} polynomials exceed the grid's y limit")
    big_n = n << rate_bits
    out = torch.empty(*batch, big_n, dtype=torch.int64, device=x.device)
    tw = _twiddle_table(log_n + rate_bits, False, x.device)
    coset = _coset_table(shift, n, x.device) if shift != 1 else None
    COSET_LDE(x.data_ptr(), None if coset is None else coset.data_ptr(),
              tw.data_ptr(), out.data_ptr(), k, log_n, rate_bits)
    return GF(out)


def lde(coeffs: GF, rate_bits: int, shift: int = 1) -> GF:
    """Low-degree extension, natural order: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if coeffs.v.is_cuda:
        return lde_cuda(GF(coeffs.v.contiguous()), rate_bits, shift)
    return lde_torch(coeffs, rate_bits, shift)


# -- extension-field wrappers (componentwise: twiddles are base field) -----

def ntt_ext(coeffs: GF2) -> GF2:
    return GF2(ntt(coeffs.a), ntt(coeffs.b))


def intt_ext(values: GF2) -> GF2:
    return GF2(intt(values.a), intt(values.b))


def coset_ntt_ext(coeffs: GF2, shift: int) -> GF2:
    return GF2(coset_ntt(coeffs.a, shift), coset_ntt(coeffs.b, shift))


def coset_intt_ext(values: GF2, shift: int) -> GF2:
    return GF2(coset_intt(values.a, shift), coset_intt(values.b, shift))


def lde_ext(coeffs: GF2, rate_bits: int, shift: int = 1) -> GF2:
    """Both components in one batched LDE."""
    out = lde(GF.stack([coeffs.a, coeffs.b], axis=0), rate_bits, shift)
    return GF2(out[0], out[1])
