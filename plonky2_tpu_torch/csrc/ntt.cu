// Batched Goldilocks NTT: natural order in and out, as a four-step (N up
// to 2^22) or three-step (up to 2^33) composition of one building block,
// a strided DFT of length n <= 2^11 run in shared memory.  The large-n
// coset LDE is the same composition with a zero-padded first step.
//
// The building block (dft_pass) is the contract of the TPU kernel
// plonky2_tpu/ops/mxu_ntt_pallas.py mxu_dft: Y = W_n X along one axis of a
// batch of columns, with an optional fused twiddle post-multiply; here also
// with an optional scaling table on load (the coset shift^j) and on store
// (n^-1 * shift^-k for the inverse coset transform, in one multiply).  For
// each batch entry b < B, column c < ncols and element j < n:
//   in  = in_ptr  + b*in_bs  + (c / cdiv)*ics_hi + (c % cdiv)*ics_lo + j*ies
//   out = out_ptr + b*out_bs + (c / cdiv)*ocs_hi + (c % cdiv)*ocs_lo + k*oes
//   y[k] = sum_j x[j] w_n^(jk), then y[k] *= w_N^(k * (c % tcm) * tsc).
// A block takes C columns (C * n <= 2048 elements, 16 KiB of shared memory),
// loads them in bit-reversed order, runs radix-2 DIT stages, and stores.
// Loads and stores walk the tile element-fastest when the element stride is
// 1 and column-fastest otherwise, so neighbouring threads touch neighbouring
// addresses whenever the layout allows.  Twiddles come from one device table
// tw[i] = w_N^i, i < N/2 (w_N^(i + N/2) = -w_N^i), N the whole transform.
//
// Four-step, N = n1 n2, j = j1 n2 + j2, k = k1 + n1 k2 (as mxu_ntt):
//   pass 1: DFT over j1 for each column j2, twiddle w_N^(k1 j2);
//   pass 2: DFT over j2 for each row k1, stored at k2 n1 + k1.
// Three-step, N = n1 n2 n3, j = j1 n2n3 + j2 n3 + j3, k = k1 + n1 k2 + n1n2 k3:
//   pass 1 as above over the n2n3 columns; pass 2: DFT over j2 for each
//   (k1, j3), twiddle w_N^(n1 k2 j3); pass 3: DFT over j3 for each (k1, k2),
//   stored at k1 + n1 k2 + n1n2 k3.
//
// The coset LDE of k polynomials of n coefficients onto N = n 2^r points
// (the contract of plonky2_tpu/ops/mxu_lde3_pallas.py mxu_lde3, and of
// field/ntt.py lde_torch) is the forward NTT of the zero-padded, shift^j
// scaled coefficients.  Only the first n1 / 2^r rows of pass 1 are nonzero:
// pass 1 reads just those (the zero-pad skip of mxu_lde3's first step, its
// n1z contraction), each repeated 2^r times in bit-reversed order, which
// makes the first r DIT stages copies that are skipped (reference
// fft.rs:169).
//
// Bound on the H100: at the main path's shapes (2^15 to 2^21 points) the
// least time is set by moving the input and output once; the four 32-bit
// products of each of the (N/2) log N butterfly multiplies come close
// behind.  This simple design moves the data 2 (or 3) times, once per pass,
// with strided accesses on the passes whose element stride is not 1, and
// re-reads twiddles from the table through L2.
//
// C interface (launches: kernel launches issued; returns cudaGetLastError()):
//   ntt(in, out, tmp, tw, scale_in, scale_out, batch, log_N, launches, stream)
//     in/out/tmp (batch, N) u64; tmp is scratch for the multi-pass plans;
//     scale_in / scale_out are N-entry tables or null.
//   coset_lde3(coeffs, coset, tw, out, k, log_n, rate_bits, launches, stream)
//     out (k, n 2^r) from coeffs (k, n); coset is the shift^j table or null.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int LOG_TILE = 11;            // 2048 u64 = 16 KiB of shared memory
constexpr int TILE = 1 << LOG_TILE;
constexpr int THREADS = 256;

struct Pass {
  const uint64_t* in;
  uint64_t* out;
  const uint64_t* scale_in;   // indexed by the input offset within a batch row
  const uint64_t* scale_out;  // indexed by the output offset within a batch row
  const uint64_t* tw;         // w_N^i, i < N/2
  int log_N;                  // the whole transform, for the twiddle table
  int log_n;                  // this pass's DFT length
  int skip;                   // zero-pad skip: only n >> skip inputs are read
  int twiddle;                // post-multiply by w_N^(k (c % tcm) tsc)
  int64_t ncols, cdiv, cols_per_block;
  int64_t in_bs, ics_hi, ics_lo, ies;
  int64_t out_bs, ocs_hi, ocs_lo, oes;
  int64_t tcm, tsc;
};

__device__ __forceinline__ uint64_t root_pow(const uint64_t* tw, int log_N,
                                             uint64_t e) {
  const uint64_t half = log_N ? (1ull << (log_N - 1)) : 1ull;
  return e < half ? tw[e] : gl::sub(0, tw[e - half]);
}

__device__ void dft_pass(const Pass& p) {
  __shared__ uint64_t sh[TILE];
  const int n = 1 << p.log_n;
  const int64_t C = p.cols_per_block;
  const int64_t blocks_per_row = p.ncols / C;
  const int64_t b = blockIdx.x / blocks_per_row;
  const int64_t c0 = (blockIdx.x % blocks_per_row) * C;
  const int tile = (int)(C * n);
  const int log_m = p.log_n - p.skip;     // log2 of the inputs read per column
  const uint64_t* in = p.in + b * p.in_bs;
  uint64_t* out = p.out + b * p.out_bs;

  // load: sh[cc*n + q] = x[bitrev_m(q >> skip)]
  for (int q = threadIdx.x; q < tile; q += blockDim.x) {
    int cc, e;
    if (p.ies == 1) { cc = q >> p.log_n; e = q & (n - 1); }
    else { cc = (int)(q % C); e = (int)(q / C); }
    // e walks the stored slots in the order of the input addresses when
    // the element stride is 1; the slot holding input j is bitrev(j) << skip
    if (e >= (n >> p.skip)) continue;
    const int64_t c = c0 + cc;
    const int64_t off = (c / p.cdiv) * p.ics_hi + (c % p.cdiv) * p.ics_lo +
                        (int64_t)e * p.ies;
    uint64_t v = in[off];
    if (p.scale_in) v = gl::mul(v, p.scale_in[off]);
    const int slot = log_m ? (int)(__brev((unsigned)e) >> (32 - log_m)) : 0;
    const int base = cc * n + (slot << p.skip);
    for (int r = 0; r < (1 << p.skip); r++) sh[base + r] = v;
  }
  __syncthreads();

  const int half_tile = tile >> 1;
  for (int s = p.skip + 1; s <= p.log_n; s++) {
    const int half = 1 << (s - 1);
    for (int bf = threadIdx.x; bf < half_tile; bf += blockDim.x) {
      const int cc = bf >> (p.log_n - 1);
      const int w = bf & ((n >> 1) - 1);
      const int j = w & (half - 1);
      const int i0 = cc * n + ((w >> (s - 1)) << s) + j;
      const uint64_t t =
          gl::mul(sh[i0 + half], p.tw[(int64_t)j << (p.log_N - s)]);
      const uint64_t a = sh[i0];
      sh[i0] = gl::add(a, t);
      sh[i0 + half] = gl::sub(a, t);
    }
    __syncthreads();
  }

  const uint64_t mask = (1ull << p.log_N) - 1;
  for (int q = threadIdx.x; q < tile; q += blockDim.x) {
    int cc, k;
    if (p.oes == 1) { cc = q >> p.log_n; k = q & (n - 1); }
    else { cc = (int)(q % C); k = (int)(q / C); }
    const int64_t c = c0 + cc;
    uint64_t v = sh[cc * n + k];
    if (p.twiddle) {
      const uint64_t e = ((uint64_t)k * (uint64_t)(c % p.tcm) *
                          (uint64_t)p.tsc) & mask;
      v = gl::mul(v, root_pow(p.tw, p.log_N, e));
    }
    const int64_t off = (c / p.cdiv) * p.ocs_hi + (c % p.cdiv) * p.ocs_lo +
                        (int64_t)k * p.oes;
    if (p.scale_out) v = gl::mul(v, p.scale_out[off]);
    out[off] = v;
  }
}

__global__ void __launch_bounds__(THREADS) dft_kernel(const Pass p) {
  dft_pass(p);
}

// The same pass under its own name, so a profile tells the LDE's launches
// from the NTT's.
__global__ void __launch_bounds__(THREADS) lde3_kernel(const Pass p) {
  dft_pass(p);
}

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

Pass make_pass(int log_n, int64_t ncols, int64_t cdiv) {
  Pass p = {};
  p.log_n = log_n;
  p.ncols = ncols;
  p.cdiv = cdiv;
  int64_t C = (int64_t)TILE >> log_n;
  C = min64(C, ncols);
  C = min64(C, cdiv);
  p.cols_per_block = C < 1 ? 1 : C;
  p.tcm = 1;
  p.tsc = 1;
  return p;
}

// The passes of a natural-order NTT of length 2^log_N, in -> out (through
// tmp when there is more than one pass).  Returns the pass count.
int plan(Pass* ps, int log_N, const uint64_t* in, uint64_t* out,
         uint64_t* tmp, const uint64_t* tw, const uint64_t* scale_in,
         const uint64_t* scale_out, int64_t in_bs, int skip) {
  const int64_t N = 1ll << log_N;
  int count;
  if (log_N <= LOG_TILE) {
    ps[0] = make_pass(log_N, 1, 1);
    ps[0].ies = 1;
    ps[0].oes = 1;
    ps[0].in = in;
    ps[0].out = out;
    count = 1;
  } else if (log_N <= 2 * LOG_TILE) {
    const int l1 = (log_N + 1) / 2, l2 = log_N / 2;
    const int64_t n1 = 1ll << l1, n2 = 1ll << l2;
    ps[0] = make_pass(l1, n2, n2);
    ps[0].ics_lo = 1; ps[0].ies = n2;
    ps[0].ocs_lo = 1; ps[0].oes = n2;
    ps[0].twiddle = 1; ps[0].tcm = n2;
    ps[0].in = in; ps[0].out = tmp;
    ps[1] = make_pass(l2, n1, n1);
    ps[1].ics_lo = n2; ps[1].ies = 1;
    ps[1].ocs_lo = 1; ps[1].oes = n1;
    ps[1].in = tmp; ps[1].out = out;
    count = 2;
  } else {
    const int l1 = LOG_TILE, lm = log_N - LOG_TILE;
    const int l2 = (lm + 1) / 2, l3 = lm / 2;
    const int64_t n1 = 1ll << l1, n2 = 1ll << l2, n3 = 1ll << l3;
    const int64_t M = n2 * n3;
    ps[0] = make_pass(l1, M, M);
    ps[0].ics_lo = 1; ps[0].ies = M;
    ps[0].ocs_lo = 1; ps[0].oes = M;
    ps[0].twiddle = 1; ps[0].tcm = M;
    ps[0].in = in; ps[0].out = tmp;
    // in place on tmp: a block reads all of its columns before it writes
    ps[1] = make_pass(l2, n1 * n3, n3);
    ps[1].ics_hi = M; ps[1].ics_lo = 1; ps[1].ies = n3;
    ps[1].ocs_hi = M; ps[1].ocs_lo = 1; ps[1].oes = n3;
    ps[1].twiddle = 1; ps[1].tcm = n3; ps[1].tsc = n1;
    ps[1].in = tmp; ps[1].out = tmp;
    ps[2] = make_pass(l3, n1 * n2, n2);
    ps[2].ics_hi = M; ps[2].ics_lo = n3; ps[2].ies = 1;
    ps[2].ocs_hi = 1; ps[2].ocs_lo = n1; ps[2].oes = n1 * n2;
    ps[2].in = tmp; ps[2].out = out;
    count = 3;
  }
  for (int i = 0; i < count; i++) {
    ps[i].tw = tw;
    ps[i].log_N = log_N;
    ps[i].in_bs = N;
    ps[i].out_bs = N;
  }
  ps[0].in_bs = in_bs;
  ps[0].skip = skip;
  ps[0].scale_in = scale_in;
  ps[count - 1].scale_out = scale_out;
  return count;
}

int run(Pass* ps, int count, int64_t batch, bool lde, cudaStream_t st,
        int* launches) {
  for (int i = 0; i < count; i++) {
    const unsigned blocks =
        (unsigned)(batch * (ps[i].ncols / ps[i].cols_per_block));
    if (lde) lde3_kernel<<<blocks, THREADS, 0, st>>>(ps[i]);
    else dft_kernel<<<blocks, THREADS, 0, st>>>(ps[i]);
    *launches += 1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ntt(const void* in, void* out, void* tmp, const void* tw,
                   const void* scale_in, const void* scale_out, int64_t batch,
                   int log_N, int* launches, void* stream) {
  *launches = 0;
  if (batch <= 0) return (int)cudaGetLastError();
  if (log_N < 0 || log_N > 3 * LOG_TILE) return (int)cudaErrorInvalidValue;
  Pass ps[3];
  const int count =
      plan(ps, log_N, (const uint64_t*)in, (uint64_t*)out, (uint64_t*)tmp,
           (const uint64_t*)tw, (const uint64_t*)scale_in,
           (const uint64_t*)scale_out, 1ll << log_N, 0);
  return run(ps, count, batch, false, (cudaStream_t)stream, launches);
}

extern "C" int coset_lde3(const void* coeffs, const void* coset,
                          const void* tw, void* out, void* tmp, int64_t k,
                          int log_n, int rate_bits, int* launches,
                          void* stream) {
  *launches = 0;
  if (k <= 0) return (int)cudaGetLastError();
  const int log_N = log_n + rate_bits;
  // the zero-pad skip happens inside the first pass, so 2^rate_bits must not
  // exceed its length (plan()'s l1)
  const int l1 = log_N <= 2 * LOG_TILE ? (log_N + 1) / 2 : LOG_TILE;
  if (log_N <= LOG_TILE || log_N > 3 * LOG_TILE || rate_bits < 0 ||
      rate_bits > l1)
    return (int)cudaErrorInvalidValue;
  Pass ps[3];
  const int count =
      plan(ps, log_N, (const uint64_t*)coeffs, (uint64_t*)out,
           (uint64_t*)tmp, (const uint64_t*)tw, (const uint64_t*)coset,
           nullptr, 1ll << log_n, rate_bits);
  return run(ps, count, k, true, (cudaStream_t)stream, launches);
}
