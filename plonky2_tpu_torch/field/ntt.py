"""Number-theoretic transform over Goldilocks on torch.

``ntt``, ``intt``, ``coset_ntt`` and ``coset_intt`` transform the last axis
of a (batch..., n) GF array, natural order in and out.  A CUDA tensor goes
to the hand-written kernel csrc/ntt.cu (``ntt_cuda``: a four- or three-step
composition of a shared-memory DFT, one to three launches per transform); a
CPU tensor to the plain torch versions ``*_torch``, the twin of reference
field/src/fft.rs:52,99,169: a radix-2 DIT on bit-reversed input, one
vectorised torch pass per stage.  ``dft_torch`` is the plain version of the
kernel's building block (a DFT along axis 0 with an optional twiddle
post-multiply).  Twiddles come from one table per (log n, direction,
device), tw[i] = w_n^i for i < n/2.

``lde`` is the commitment LDE.  A CUDA tensor goes to csrc/ntt.cu's ``lde``
entry (``lde_cuda``: the forward plan with the zero-pad skip and the coset
scaling in its first pass), a CPU tensor to ``lde_torch``, its plain
version.  Extension (GF2) codewords transform componentwise.
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

NTT = CudaKernel("ntt.cu", "ntt", [ctypes.c_void_p] * 6 + [
    ctypes.c_int64, ctypes.c_int])
LDE = CudaKernel("ntt.cu", "lde", [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int])

# ntt.cu's plans (csrc/ntt.cu pass_logs, twiddle_split): one pass up to
# 2^LOG_TILE points, two up to 2^MAX_TWO_PASS, three up to 2^MAX_LOG_N
LOG_TILE = 13
MAX_TWO_PASS = 22
MAX_LOG_N = 33


@lru_cache(maxsize=32)
def _twiddle_table(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """tw[i] = w^i for i < n/2, w the (inverse) primitive n-th root."""
    root = gl64.primitive_root_of_unity(log_n)
    if inverse:
        root = pow(root, gl64.ORDER_INT - 2, gl64.ORDER_INT)
    tw = gl64.powers(root, max((1 << log_n) >> 1, 1))
    return torch.from_numpy(tw.view(np.int64).copy()).to(device)


def _twiddle_split(log_n: int) -> int:
    """b of the kernel's tables, w^e = thi[e >> b] * tlo[e % 2^b]."""
    return 0 if log_n <= LOG_TILE else log_n // 2


def _first_pass_log(log_n: int) -> int:
    """log2 of the length of the first pass of ntt.cu's plan."""
    if log_n <= LOG_TILE:
        return log_n
    if log_n <= MAX_TWO_PASS:
        return (log_n + 1) // 2
    return (log_n + 2) // 3


@lru_cache(maxsize=32)
def _kernel_tables(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """ntt.cu's twiddle tables for a transform of 2^log_n points: thi[x] =
    w^(x 2^b) for x < 2^(log_n - b), then tlo[x] = w^x for x < 2^b."""
    root = gl64.primitive_root_of_unity(log_n)
    if inverse:
        root = pow(root, gl64.ORDER_INT - 2, gl64.ORDER_INT)
    b = _twiddle_split(log_n)
    thi = gl64.powers(pow(root, 1 << b, gl64.ORDER_INT), 1 << (log_n - b))
    tlo = gl64.powers(root, 1 << b)
    return torch.from_numpy(np.concatenate([thi, tlo]).view(np.int64)).to(device)


@lru_cache(maxsize=32)
def _coset_table(shift: int, n: int, device: torch.device) -> torch.Tensor:
    """[shift^0, ..., shift^(n-1)]."""
    return torch.from_numpy(gl64.powers(shift, n).view(np.int64).copy()).to(device)


@lru_cache(maxsize=32)
def _inverse_scale_table(shift: int, n: int, device: torch.device) -> torch.Tensor:
    """[n^-1 shift^-k for k < n]: the inverse transform's 1/n and the inverse
    coset shift in one table."""
    shift_inv = pow(shift, gl64.ORDER_INT - 2, gl64.ORDER_INT)
    table = gl64.mul(gl64.powers(shift_inv, n), np.uint64(_n_inv(n)))
    return torch.from_numpy(table.view(np.int64).copy()).to(device)


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


def ntt_torch(coeffs: GF) -> GF:
    """values[i] = poly(g^i) over the order-n subgroup, natural order."""
    n = coeffs.shape[-1]
    return ntt_br(coeffs.take(_brp(n, coeffs.device), axis=-1))


def intt_torch(values: GF) -> GF:
    """Inverse NTT: values over the subgroup -> coefficients."""
    n = values.shape[-1]
    out = ntt_br(values.take(_brp(n, values.device), axis=-1), inverse=True)
    return out * _n_inv(n)


def coset_ntt_torch(coeffs: GF, shift: int) -> GF:
    """Evaluate on the coset shift*H (reference polynomial/mod.rs coset_fft)."""
    n = coeffs.shape[-1]
    return ntt_torch(GF(mul(coeffs.v, _coset_table(shift, n, coeffs.device))))


def coset_intt_torch(values: GF, shift: int) -> GF:
    """Inverse of coset_ntt_torch."""
    n = values.shape[-1]
    shift_inv = pow(shift, gl64.ORDER_INT - 2, gl64.ORDER_INT)
    return GF(mul(intt_torch(values).v,
                  _coset_table(shift_inv, n, values.device)))


def dft_torch(x: GF, twiddles: GF | None = None) -> GF:
    """Plain version of the kernel's building block, the contract of
    plonky2_tpu/ops/mxu_ntt_pallas.py mxu_dft: Y = W x along axis 0 of an
    (n1, m) array, W[k, j] = w_n1^(jk), then an optional elementwise
    post-multiply by (n1, m) twiddles."""
    y = ntt_torch(x.transpose(1, 0)).transpose(1, 0)
    return y if twiddles is None else y * twiddles


def ntt_cuda(x: torch.Tensor, inverse: bool = False,
             scale_in: torch.Tensor | None = None,
             scale_out: torch.Tensor | None = None) -> torch.Tensor:
    """The transform of the last axis of x on the card through csrc/ntt.cu,
    natural order in and out: x is multiplied by ``scale_in`` (n entries) as
    it is loaded and the result by ``scale_out`` as it is stored.

    Replaces the TPU kernel plonky2_tpu/ops/mxu_ntt_pallas.py mxu_dft (and
    mxu_ntt, which composes it).  On the H100 it is bound by moving its input
    and output once, with the butterflies' integer multiplies close behind;
    the kernel moves the data once per pass (one pass up to 2^13 points, two
    up to 2^22, three above)."""
    check_cuda_tensor(x, "ntt input")
    n = x.shape[-1]
    log_n = log2_strict(n)
    if log_n > MAX_LOG_N:
        raise ValueError(f"ntt: 2^{log_n} points exceed the kernel's 2^{MAX_LOG_N}")
    batch = x.numel() // n if n else 0
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if log_n > LOG_TILE else out
    tables = _kernel_tables(log_n, inverse, x.device)
    NTT(x.data_ptr(), out.data_ptr(), tmp.data_ptr(), tables.data_ptr(),
        None if scale_in is None else scale_in.data_ptr(),
        None if scale_out is None else scale_out.data_ptr(), batch, log_n)
    return out


def ntt(coeffs: GF) -> GF:
    """values[i] = poly(g^i) over the order-n subgroup, natural order."""
    if coeffs.v.is_cuda:
        return GF(ntt_cuda(coeffs.v.contiguous()))
    return ntt_torch(coeffs)


def intt(values: GF) -> GF:
    """Inverse NTT: values over the subgroup -> coefficients."""
    if values.v.is_cuda:
        n = values.shape[-1]
        return GF(ntt_cuda(values.v.contiguous(), inverse=True,
                           scale_out=_inverse_scale_table(1, n, values.device)))
    return intt_torch(values)


def coset_ntt(coeffs: GF, shift: int) -> GF:
    """Evaluate on the coset shift*H (reference polynomial/mod.rs coset_fft)."""
    if coeffs.v.is_cuda:
        n = coeffs.shape[-1]
        return GF(ntt_cuda(coeffs.v.contiguous(),
                           scale_in=_coset_table(shift, n, coeffs.device)))
    return coset_ntt_torch(coeffs, shift)


def coset_intt(values: GF, shift: int) -> GF:
    """Inverse of coset_ntt."""
    if values.v.is_cuda:
        n = values.shape[-1]
        return GF(ntt_cuda(values.v.contiguous(), inverse=True,
                           scale_out=_inverse_scale_table(shift, n,
                                                          values.device)))
    return coset_intt_torch(values, shift)


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
    """The LDE on the card through csrc/ntt.cu's ``lde`` entry, same
    contract as lde_torch, for every size.

    Replaces the TPU kernels plonky2_tpu/ops/mxu_lde_pallas.py mxu_lde and
    plonky2_tpu/ops/mxu_lde3_pallas.py mxu_lde3.  On the H100 it is bound
    by moving its input and output once; the kernel is the NTT's plan of
    length n 2^rate_bits with the coset scaling fused into the first pass's
    load, which reads only the n nonzero coefficients and writes each
    2^rate_bits times in place of the first rate_bits butterfly stages."""
    x = coeffs.v
    n = x.shape[-1]
    log_n = log2_strict(n)
    log_big = log_n + rate_bits
    if log_big > MAX_LOG_N:
        raise ValueError(f"lde: 2^{log_big} points exceed the kernel's 2^{MAX_LOG_N}")
    first_pass = _first_pass_log(log_big)
    if not 0 <= rate_bits <= first_pass:
        raise ValueError(f"lde: rate_bits {rate_bits} exceeds the first "
                         f"pass's 2^{first_pass} points at 2^{log_big}")
    check_cuda_tensor(x, "lde coeffs")
    batch = x.shape[:-1]
    k = x.numel() // n
    out = torch.empty(*batch, n << rate_bits, dtype=torch.int64, device=x.device)
    tmp = torch.empty_like(out) if log_big > LOG_TILE else out
    tables = _kernel_tables(log_big, False, x.device)
    coset = _coset_table(shift, n, x.device) if shift != 1 else None
    LDE(x.data_ptr(), None if coset is None else coset.data_ptr(),
        tables.data_ptr(), out.data_ptr(), tmp.data_ptr(), k, log_n, rate_bits)
    return GF(out)


def lde(coeffs: GF, rate_bits: int, shift: int = 1) -> GF:
    """Low-degree extension, natural order: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
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
