// Coset low-degree extension over Goldilocks: k polynomials of n
// coefficients evaluated on shift * H, |H| = N = n * 2^rate_bits, natural
// order out (the contract of field/ntt.py lde, reference fft.rs:169):
//   1. scale coefficient j by shift^j (a table, or none when shift = 1);
//   2. scatter into bit-reversed order with each element repeated 2^r times:
//      the first r DIT stages on zero-padded input only copy, so they are
//      skipped;
//   3. radix-2 DIT butterflies for stages r+1 .. log N, twiddles from one
//      device table tw[i] = w_N^i, i < N/2 (stage s uses tw[j * N / 2^s]).
//
// Replaces the TPU kernel plonky2_tpu/ops/mxu_lde_pallas.py mxu_lde
// (_lde_kernel, tables _lde_tables), which ran the LDE as a two-step
// four-step DFT of int8 balanced-digit matrix-unit dots into a (t1, t2)
// layout.  That layout, its permutations and the digit planes stay behind:
// Hopper has native 64-bit integer multiplies (__umul64hi), so the
// butterflies are plain modular arithmetic.
//
// Bound on the H100: at the slice's shapes (k = 4, n = 2^20, r = 1) the
// least time is set by moving the k*n input and the k*N output once; the
// integer multiplies of the (log N - r) * N/2 * k butterflies (four 32-bit
// products each) come close behind.  This design
// is the simple one: a first pass runs stages r+1 .. 11 inside one block's
// 2048-element shared-memory tile (one global read of the coefficients, one
// write), and every later stage is one launch over device memory (a read
// and a write of the whole output each).  A faster version would run the
// later stages in shared memory too (a strided second tile pass).
//
// C interface: coset_lde(coeffs, coset, tw, out, k, log_n, rate_bits,
// launches, stream) writes out (k, N) from coeffs (k, n); coset is the
// shift^j table (n entries) or null; stores the number of kernel launches
// (one tile pass plus one per later stage) in *launches; returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int LOG_TILE = 11;            // 2048 u64 = 16 KiB of shared memory
constexpr int TILE = 1 << LOG_TILE;

__global__ void lde_tile_kernel(const uint64_t* __restrict__ coeffs,
                                const uint64_t* __restrict__ coset,
                                const uint64_t* __restrict__ tw,
                                uint64_t* __restrict__ out, int log_n,
                                int rate_bits, int log_tile) {
  __shared__ uint64_t sh[TILE];
  const int log_N = log_n + rate_bits;
  const int64_t n = 1ll << log_n;
  const int64_t N = 1ll << log_N;
  const int tile = 1 << log_tile;
  const int64_t base = (int64_t)blockIdx.x << log_tile;
  const uint64_t* c = coeffs + (int64_t)blockIdx.y * n;
  for (int q = threadIdx.x; q < tile; q += blockDim.x) {
    const uint64_t i = (uint64_t)(base + q) >> rate_bits;
    const uint64_t j = log_n ? (__brevll(i) >> (64 - log_n)) : 0;
    const uint64_t v = c[j];
    sh[q] = coset ? gl::mul(v, coset[j]) : v;
  }
  __syncthreads();
  for (int s = rate_bits + 1; s <= log_tile; s++) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < tile / 2; b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b >> (s - 1)) << s) + j;
      const uint64_t t = gl::mul(sh[i0 + half], tw[(int64_t)j << (log_N - s)]);
      const uint64_t a = sh[i0];
      sh[i0] = gl::add(a, t);
      sh[i0 + half] = gl::sub(a, t);
    }
    __syncthreads();
  }
  uint64_t* o = out + (int64_t)blockIdx.y * N + base;
  for (int q = threadIdx.x; q < tile; q += blockDim.x) o[q] = sh[q];
}

// One radix-2 DIT stage s over device memory: one butterfly per thread,
// k * N/2 butterflies.
__global__ void ntt_stage_kernel(uint64_t* __restrict__ x,
                                 const uint64_t* __restrict__ tw, int log_N,
                                 int s, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t poly = idx >> (log_N - 1);
  const int64_t b = idx & ((1ll << (log_N - 1)) - 1);
  const int64_t half = 1ll << (s - 1);
  const int64_t j = b & (half - 1);
  const int64_t i0 = (poly << log_N) + ((b >> (s - 1)) << s) + j;
  const uint64_t t = gl::mul(x[i0 + half], tw[j << (log_N - s)]);
  const uint64_t a = x[i0];
  x[i0] = gl::add(a, t);
  x[i0 + half] = gl::sub(a, t);
}

}  // namespace

extern "C" int coset_lde(const void* coeffs, const void* coset,
                         const void* tw, void* out, int64_t k, int log_n,
                         int rate_bits, int* launches, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int log_N = log_n + rate_bits;
  *launches = 0;
  if (k > 0) {
    const int log_tile = log_N < LOG_TILE ? log_N : LOG_TILE;
    const dim3 grid((unsigned)(1ll << (log_N - log_tile)), (unsigned)k);
    const int threads = log_tile > 0 ? (1 << log_tile) / 2 : 1;
    lde_tile_kernel<<<grid, threads, 0, st>>>(
        (const uint64_t*)coeffs, (const uint64_t*)coset,
        (const uint64_t*)tw, (uint64_t*)out, log_n, rate_bits, log_tile);
    *launches += 1;
    const int first = (log_tile > rate_bits ? log_tile : rate_bits) + 1;
    for (int s = first; s <= log_N; s++) {
      const int64_t total = k << (log_N - 1);
      const int block = 256;
      ntt_stage_kernel<<<(unsigned)((total + block - 1) / block), block, 0,
                         st>>>((uint64_t*)out, (const uint64_t*)tw, log_N, s,
                               total);
      *launches += 1;
    }
  }
  return (int)cudaGetLastError();
}
