// Batched Goldilocks NTT and coset LDE: natural order in and out, as a
// one-, two- or three-pass composition of one building block, a strided
// DFT of length n <= 2^13 run in a shared-memory tile.
//
// The building block (dft_pass) is the contract of the TPU kernel
// plonky2_tpu/ops/mxu_ntt_pallas.py mxu_dft: Y = W_n X along one axis of a
// batch of columns, with an optional fused twiddle post-multiply; here also
// with an optional scaling table on load (the coset shift^j) and on store
// (n^-1 * shift^-k for the inverse coset transform, in one multiply).  For
// each batch entry b, column c < ncols and element j < n:
//   in  = in_ptr  + b*in_bs  + (c / cdiv)*ics_hi + (c % cdiv)*ics_lo + j*ies
//   out = out_ptr + b*out_bs + (c / cdiv)*ocs_hi + (c % cdiv)*ocs_lo + k*oes
//   y[k] = sum_j x[j] w_n^(jk), then y[k] *= w_N^(k * (c % tcm) * tsc).
//
// Plans (N = 2^log_N the whole transform):
//   log_N <= 13: one pass over each row.
//   log_N <= 22: four-step, N = n1 n2, j = j1 n2 + j2, k = k1 + n1 k2:
//     pass 1: DFT over j1 for each column j2, twiddle w_N^(k1 j2);
//     pass 2: DFT over j2 for each row k1, stored at k2 n1 + k1.
//   above: three-step, N = n1 n2 n3, j = j1 n2n3 + j2 n3 + j3,
//     k = k1 + n1 k2 + n1n2 k3: pass 1 as above over the n2n3 columns;
//     pass 2: DFT over j2 for each (k1, j3), twiddle w_N^(n1 k2 j3), in
//     place; pass 3: DFT over j3 for each (k1, k2), k1 fastest, stored at
//     k1 + n1 k2 + n1n2 k3.
// The pass lengths are balanced: no pass is longer than 2^11 points, so a
// strided pass takes at least 4 columns per tile (16 up to 2^18 points).
// Two passes with short row segments beat three with long ones at 2^20 and
// 2^21 points (PERF.md).
//
// The coset LDE of k polynomials of n coefficients onto N = n 2^r points
// (the contract of plonky2_tpu/ops/mxu_lde_pallas.py mxu_lde and of
// plonky2_tpu/ops/mxu_lde3_pallas.py mxu_lde3, and of field/ntt.py
// lde_torch) is the forward plan over the zero-padded, shift^j-scaled
// coefficients.  Only the first n1 / 2^r elements of each pass-1 column are
// nonzero: pass 1 reads just those and writes each 2^r times, which is the
// whole of the first radix-2^r stage on that input (reference fft.rs:169
// skips the same copy stages).
//
// Bound on the H100: moving the input and output once sets the least time;
// the (N/2) log N butterfly multiplies (four IMAD.WIDE.U32 each) come close
// behind, and their instruction issue, not the multiplier, is what a pass
// can saturate.  What the design does about it:
//  - tiles of up to 2^13 elements in dynamic shared memory (68 KiB) and up
//    to 16 columns, so a strided pass reads and writes row segments of up
//    to 128 bytes; a tile is laid out element-major, column-fastest, so
//    neighbouring threads touch neighbouring columns in shared memory as in
//    device memory; a thread holds 8 values, so a block has up to 1024
//    threads (at most 64 registers each);
//  - inside a tile, Stockham radix-8 (and one radix-4 or radix-2) passes
//    with the butterflies in registers: a radix-8 pass is three radix-2
//    stages for one shared-memory round trip and two barriers;
//  - shared-memory indices are padded by one element per 16 (a + a/16),
//    which keeps the power-of-two strides of the passes free of bank
//    conflicts;
//  - twiddles come from two small tables, w_N^(x 2^b) (which also holds
//    every pass's roots) and w_N^x for x < 2^b, both L1-resident; the
//    four-step twiddle w_N^e is the product of one entry of each;
//  - persistent blocks (as many as fit on the card) walk the tiles, so a
//    block's setup is paid once; smaller tiles (shorter passes, or fewer
//    columns when a pass has too few tiles to fill the card) put several
//    blocks on an SM, whose loads then overlap each other's butterflies.
//
// C interface (launches: kernel launches issued; returns cudaGetLastError()):
//   ntt(in, out, tmp, tables, scale_in, scale_out, batch, log_N, launches,
//       stream)
//     in/out/tmp (batch, N) u64; tmp is scratch for the multi-pass plans;
//     scale_in / scale_out are N-entry tables or null; tables holds
//     w_N^(x 2^b) for x < 2^(log_N - b), then w_N^x for x < 2^b, with
//     b = twiddle_split(log_N).
//   lde(coeffs, coset, tables, out, tmp, k, log_n, rate_bits, launches,
//       stream)
//     out (k, n 2^r) from coeffs (k, n); coset is the shift^j table or null;
//     tables as for ntt at log_N = log_n + rate_bits.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int LOG_TILE = 13;     // a tile holds up to 2^13 u64 (+ padding)
constexpr int LOG_VALS = 3;      // values a thread holds in a radix pass
constexpr int VALS = 1 << LOG_VALS;
constexpr int MAX_THREADS = 1 << (LOG_TILE - LOG_VALS);
constexpr int MIN_BLOCKS = 65536 / (MAX_THREADS * 64);  // <= 64 registers
constexpr int MAX_TWO_PASS = 22;  // two passes of <= 2^11 points
constexpr int MAX_C = 16;  // columns per tile: 128-byte row segments
constexpr int MAX_LOG_N = 33;

__device__ __forceinline__ int pad(int a) { return a + (a >> 4); }

struct Pass {
  const uint64_t* in;
  uint64_t* out;
  const uint64_t* scale_in;   // indexed by the input offset within a batch row
  const uint64_t* scale_out;  // indexed by the output offset within a batch row
  const uint64_t* thi;        // w_N^(x 2^b), x < 2^(log_N - b)
  const uint64_t* tlo;        // w_N^x, x < 2^b
  int log_N, b;
  int log_n;                  // this pass's DFT length
  int skip;                   // zero-pad skip: only n >> skip inputs are read
  int twiddle;                // post-multiply by w_N^(k (c % tcm) tsc)
  int log_C;                  // columns per tile
  int log_cdiv, log_tcm;      // cdiv = 2^log_cdiv, tcm = 2^log_tcm
  int log_tiles_per_row;
  int64_t ncols, tiles;
  int64_t in_bs, ics_hi, ics_lo, ies;
  int64_t out_bs, ocs_hi, ocs_lo, oes;
  int64_t tsc;
};

// The radix-4 and radix-8 roots w_4 = w_N^(N/4) and w_8^m = w_N^(mN/8).
struct Roots {
  uint64_t w4, w8, w83;
};

// In-register DFTs of length 2, 4 and 8, natural order in and out:
// y[q] = sum_r v[r] w_R^(rq).
__device__ __forceinline__ void dft2(uint64_t& a, uint64_t& b) {
  const uint64_t t = a;
  a = gl::add(t, b);
  b = gl::sub(t, b);
}

__device__ __forceinline__ void dft4(uint64_t& v0, uint64_t& v1, uint64_t& v2,
                                     uint64_t& v3, uint64_t w4) {
  const uint64_t a0 = gl::add(v0, v2), a1 = gl::sub(v0, v2);
  const uint64_t b0 = gl::add(v1, v3), b1 = gl::mul(gl::sub(v1, v3), w4);
  v0 = gl::add(a0, b0);
  v2 = gl::sub(a0, b0);
  v1 = gl::add(a1, b1);
  v3 = gl::sub(a1, b1);
}

template <int R>
__device__ __forceinline__ void dft(uint64_t* v, const Roots& w) {
  if (R == 2) {
    dft2(v[0], v[1]);
  } else if (R == 4) {
    dft4(v[0], v[1], v[2], v[3], w.w4);
  } else {
    // even and odd halves, then one radix-2 stage with w_8^q
    dft4(v[0], v[2], v[4], v[6], w.w4);
    dft4(v[1], v[3], v[5], v[7], w.w4);
    v[3] = gl::mul(v[3], w.w8);
    v[5] = gl::mul(v[5], w.w4);
    v[7] = gl::mul(v[7], w.w83);
    dft2(v[0], v[1]);
    dft2(v[2], v[3]);
    dft2(v[4], v[5]);
    dft2(v[6], v[7]);
    // y[q] sits at v[2q], y[q + 4] at v[2q + 1]
    uint64_t y[8];
#pragma unroll
    for (int q = 0; q < 4; q++) {
      y[q] = v[2 * q];
      y[q + 4] = v[2 * q + 1];
    }
#pragma unroll
    for (int q = 0; q < 8; q++) v[q] = y[q];
  }
}

// One Stockham radix-R pass over the tile: sub-transforms of length Ns
// become length Ns R.  Group (column cc, j < n/R) reads x[j + r n/R],
// twiddles by w_{Ns R}^((j % Ns) r), runs a length-R DFT and writes
// y[(j / Ns) Ns R + j % Ns + r Ns].  The tile is element-major,
// column-fastest: element e of column cc sits at pad(e C + cc).
template <int R, int LOG_R>
__device__ __forceinline__ void radix_pass(uint64_t* sh, const Pass& p,
                                           int log_ns, const Roots& w) {
  constexpr int G = VALS / R;
  const int log_C = p.log_C;
  const int C = 1 << log_C;
  const int q_log = p.log_n - LOG_R;
  const int groups = C << q_log;
  const int ns_mask = (1 << log_ns) - 1;
  const int root_shift = p.log_N - p.b - log_ns - LOG_R;
  uint64_t v[G][R];
#pragma unroll
  for (int g = 0; g < G; g++) {
    const int idx = threadIdx.x + g * blockDim.x;
    if (idx < groups) {
      const int cc = idx & (C - 1), j = idx >> log_C;
#pragma unroll
      for (int r = 0; r < R; r++)
        v[g][r] = sh[pad(((j + (r << q_log)) << log_C) + cc)];
      const int jm = j & ns_mask;
      if (jm) {
#pragma unroll
        for (int r = 1; r < R; r++)
          v[g][r] = gl::mul(v[g][r], __ldg(p.thi + ((jm * r) << root_shift)));
      }
      dft<R>(v[g], w);
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; g++) {
    const int idx = threadIdx.x + g * blockDim.x;
    if (idx < groups) {
      const int cc = idx & (C - 1), j = idx >> log_C;
      const int base = ((j >> log_ns) << (log_ns + LOG_R)) + (j & ns_mask);
#pragma unroll
      for (int r = 0; r < R; r++)
        sh[pad(((base + (r << log_ns)) << log_C) + cc)] = v[g][r];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void dft_pass(const Pass& p) {
  extern __shared__ uint64_t sh[];
  const int log_n = p.log_n, log_C = p.log_C;
  const int C = 1 << log_C;
  const int n = 1 << log_n;
  const int log_m = log_n - p.skip;  // inputs read per column
  const int64_t N_mask = (1ll << p.log_N) - 1;
  const int64_t b_mask = (1ll << p.b) - 1;
  const int rs = p.log_N - p.b;      // log2 of thi's length
  Roots w;
  w.w4 = rs >= 2 ? __ldg(p.thi + (1 << (rs - 2))) : 0;
  w.w8 = rs >= 3 ? __ldg(p.thi + (1 << (rs - 3))) : 0;
  w.w83 = rs >= 3 ? __ldg(p.thi + (3 << (rs - 3))) : 0;

  const int64_t cdiv_mask = (1ll << p.log_cdiv) - 1;
  const int64_t tcm_mask = (1ll << p.log_tcm) - 1;
  for (int64_t t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int64_t b = t >> p.log_tiles_per_row;
    const int64_t c0 = (t & ((1ll << p.log_tiles_per_row) - 1)) << log_C;
    const uint64_t* in = p.in + b * p.in_bs;
    uint64_t* out = p.out + b * p.out_bs;

    // load: element e of column cc to slots (e 2^skip + i) for i < 2^skip
    for (int q = threadIdx.x; q < (C << log_m); q += blockDim.x) {
      int cc, e;
      if (p.ies == 1) { cc = q >> log_m; e = q & ((1 << log_m) - 1); }
      else { cc = q & (C - 1); e = q >> log_C; }
      const int64_t c = c0 + cc;
      const int64_t off = (c >> p.log_cdiv) * p.ics_hi +
                          (c & cdiv_mask) * p.ics_lo + (int64_t)e * p.ies;
      uint64_t v = in[off];
      if (p.scale_in) v = gl::mul(v, p.scale_in[off]);
      for (int i = 0; i < (1 << p.skip); i++)
        sh[pad((((e << p.skip) + i) << log_C) + cc)] = v;
    }
    __syncthreads();

    int log_ns = p.skip;
    while (log_n - log_ns >= 3) { radix_pass<8, 3>(sh, p, log_ns, w); log_ns += 3; }
    if (log_n - log_ns == 2) radix_pass<4, 2>(sh, p, log_ns, w);
    else if (log_n - log_ns == 1) radix_pass<2, 1>(sh, p, log_ns, w);

    for (int q = threadIdx.x; q < (C << log_n); q += blockDim.x) {
      int cc, k;
      if (p.oes == 1) { cc = q >> log_n; k = q & (n - 1); }
      else { cc = q & (C - 1); k = q >> log_C; }
      const int64_t c = c0 + cc;
      uint64_t v = sh[pad((k << log_C) + cc)];
      if (p.twiddle) {
        const uint64_t e = ((uint64_t)k * (uint64_t)(c & tcm_mask) *
                            (uint64_t)p.tsc) & N_mask;
        v = gl::mul(v, gl::mul(__ldg(p.thi + (e >> p.b)),
                               __ldg(p.tlo + (e & b_mask))));
      }
      const int64_t off = (c >> p.log_cdiv) * p.ocs_hi +
                          (c & cdiv_mask) * p.ocs_lo + (int64_t)k * p.oes;
      if (p.scale_out) v = gl::mul(v, p.scale_out[off]);
      out[off] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
dft_kernel(const Pass p) {
  dft_pass(p);
}

// The same pass under its own name, so a profile tells the LDE's launches
// from the NTT's.
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
lde_kernel(const Pass p) {
  dft_pass(p);
}

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The split of the twiddle tables: w_N^e = thi[e >> b] * tlo[e & (2^b - 1)].
// thi also holds every pass's roots, so it must be as long as the longest
// pass: the whole transform when there is one pass.  (field/ntt.py
// _twiddle_split mirrors this.)
int twiddle_split(int log_N) { return log_N <= LOG_TILE ? 0 : log_N / 2; }

// The pass lengths of a transform of 2^log_N points.  (field/ntt.py
// _first_pass_log mirrors the first one.)
int pass_logs(int log_N, int* l) {
  if (log_N <= LOG_TILE) { l[0] = log_N; return 1; }
  if (log_N <= MAX_TWO_PASS) { l[0] = (log_N + 1) / 2; l[1] = log_N / 2; return 2; }
  l[0] = (log_N + 2) / 3;
  l[1] = (log_N - l[0] + 1) / 2;
  l[2] = log_N - l[0] - l[1];
  return 3;
}

int log2_floor(int64_t x) {
  int l = 0;
  while ((2ll << l) <= x) l++;
  return l;
}

// A pass of length 2^log_n over ncols columns (powers of two), taking
// columns in groups of cdiv (see the address formula at the top).
Pass make_pass(int log_n, int64_t ncols, int64_t cdiv) {
  Pass p = {};
  p.log_n = log_n;
  p.ncols = ncols;
  p.log_cdiv = log2_floor(cdiv);
  p.log_C = log2_floor(min64(min64((int64_t)1 << (LOG_TILE - log_n),
                                   min64(ncols, MAX_C)), cdiv));
  p.tsc = 1;
  return p;
}

// The passes of a natural-order NTT of length 2^log_N, in -> out (through
// tmp when there is more than one pass).  Returns the pass count.
int plan(Pass* ps, int log_N, const uint64_t* in, uint64_t* out,
         uint64_t* tmp, const uint64_t* tables, const uint64_t* scale_in,
         const uint64_t* scale_out, int64_t in_bs, int skip) {
  const int64_t N = 1ll << log_N;
  int l[3];
  const int count = pass_logs(log_N, l);
  if (count == 1) {
    ps[0] = make_pass(log_N, 1, 1);
    ps[0].ies = 1;
    ps[0].oes = 1;
    ps[0].in = in;
    ps[0].out = out;
  } else if (count == 2) {
    const int64_t n1 = 1ll << l[0], n2 = 1ll << l[1];
    ps[0] = make_pass(l[0], n2, n2);
    ps[0].ics_lo = 1; ps[0].ies = n2;
    ps[0].ocs_lo = 1; ps[0].oes = n2;
    ps[0].twiddle = 1; ps[0].log_tcm = l[1];
    ps[0].in = in; ps[0].out = tmp;
    ps[1] = make_pass(l[1], n1, n1);
    ps[1].ics_lo = n2; ps[1].ies = 1;
    ps[1].ocs_lo = 1; ps[1].oes = n1;
    ps[1].in = tmp; ps[1].out = out;
  } else {
    const int64_t n1 = 1ll << l[0], n2 = 1ll << l[1], n3 = 1ll << l[2];
    const int64_t M = n2 * n3;
    ps[0] = make_pass(l[0], M, M);
    ps[0].ics_lo = 1; ps[0].ies = M;
    ps[0].ocs_lo = 1; ps[0].oes = M;
    ps[0].twiddle = 1; ps[0].log_tcm = l[1] + l[2];
    ps[0].in = in; ps[0].out = tmp;
    // c = k1 n3 + j3; in place on tmp: a tile reads all of its columns
    // before it writes them
    ps[1] = make_pass(l[1], n1 * n3, n3);
    ps[1].ics_hi = M; ps[1].ics_lo = 1; ps[1].ies = n3;
    ps[1].ocs_hi = M; ps[1].ocs_lo = 1; ps[1].oes = n3;
    ps[1].twiddle = 1; ps[1].log_tcm = l[2]; ps[1].tsc = n1;
    ps[1].in = tmp; ps[1].out = tmp;
    // c = k2 n1 + k1, k1 fastest so that a tile's stores are runs
    ps[2] = make_pass(l[2], n1 * n2, n1);
    ps[2].ics_hi = n3; ps[2].ics_lo = M; ps[2].ies = 1;
    ps[2].ocs_hi = n1; ps[2].ocs_lo = 1; ps[2].oes = n1 * n2;
    ps[2].in = tmp; ps[2].out = out;
  }
  const int b = twiddle_split(log_N);
  for (int i = 0; i < count; i++) {
    ps[i].thi = tables;
    ps[i].tlo = tables + (1ll << (log_N - b));
    ps[i].log_N = log_N;
    ps[i].b = b;
    ps[i].in_bs = N;
    ps[i].out_bs = N;
  }
  ps[0].in_bs = in_bs;
  ps[0].skip = skip;
  ps[0].scale_in = scale_in;
  ps[count - 1].scale_out = scale_out;
  return count;
}

size_t smem_bytes(int log_tile) {
  const int64_t tile = 1ll << log_tile;
  return (size_t)(tile + (tile >> 4) + 1) * sizeof(uint64_t);
}

// Launch every pass with as many persistent blocks as fit on the card.  A
// pass whose tiles would leave SMs idle takes fewer columns per tile (the
// device memory such a pass touches fits in L2, where a short row segment
// costs little).
int run(Pass* ps, int count, int64_t batch, bool lde, cudaStream_t st,
        int* launches) {
  static int sms = 0;
  void (*kernel)(const Pass) = lde ? lde_kernel : dft_kernel;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (auto k : {dft_kernel, lde_kernel})
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes(LOG_TILE));
    const int err = (int)cudaGetLastError();
    if (err) { sms = 0; return err; }
  }
  for (int i = 0; i < count; i++) {
    Pass& p = ps[i];
    while (p.log_C > 0 && (batch * (p.ncols >> p.log_C)) < 2 * sms) p.log_C--;
    p.log_tiles_per_row = log2_floor(p.ncols) - p.log_C;
    p.tiles = batch << p.log_tiles_per_row;
    const int log_tile = p.log_n + p.log_C;
    const int threads = 1 << (log_tile > LOG_VALS + 5 ? log_tile - LOG_VALS : 5);
    const size_t smem = smem_bytes(log_tile);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = (unsigned)min64(p.tiles, fit);
    if (lde) lde_kernel<<<blocks, threads, smem, st>>>(p);
    else dft_kernel<<<blocks, threads, smem, st>>>(p);
    *launches += 1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ntt(const void* in, void* out, void* tmp, const void* tables,
                   const void* scale_in, const void* scale_out, int64_t batch,
                   int log_N, int* launches, void* stream) {
  *launches = 0;
  if (batch <= 0) return (int)cudaGetLastError();
  if (log_N < 0 || log_N > MAX_LOG_N) return (int)cudaErrorInvalidValue;
  Pass ps[3];
  const int count =
      plan(ps, log_N, (const uint64_t*)in, (uint64_t*)out, (uint64_t*)tmp,
           (const uint64_t*)tables, (const uint64_t*)scale_in,
           (const uint64_t*)scale_out, 1ll << log_N, 0);
  return run(ps, count, batch, false, (cudaStream_t)stream, launches);
}

extern "C" int lde(const void* coeffs, const void* coset, const void* tables,
                   void* out, void* tmp, int64_t k, int log_n, int rate_bits,
                   int* launches, void* stream) {
  *launches = 0;
  if (k <= 0) return (int)cudaGetLastError();
  const int log_N = log_n + rate_bits;
  // the zero-pad skip happens inside the first pass, so 2^rate_bits must
  // not exceed its length
  int l[3];
  pass_logs(log_N, l);
  if (log_n < 0 || log_N > MAX_LOG_N || rate_bits < 0 || rate_bits > l[0])
    return (int)cudaErrorInvalidValue;
  Pass ps[3];
  const int count =
      plan(ps, log_N, (const uint64_t*)coeffs, (uint64_t*)out,
           (uint64_t*)tmp, (const uint64_t*)tables, (const uint64_t*)coset,
           nullptr, 1ll << log_n, rate_bits);
  return run(ps, count, k, true, (cudaStream_t)stream, launches);
}
