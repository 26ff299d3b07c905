// Elementwise Goldilocks arithmetic: one launch per field operation.
//
// Replaces no TPU kernel.  The JAX package leaves its elementwise field ops
// to XLA, which fuses each chain of u32 limb ops into one loop; eager torch
// runs the same chain (field/goldilocks.py add_torch, mul_torch, ...) as
// 10-40 generic int64 launches, each writing a full-size temporary.  Each
// entry below is one op of field/goldilocks.py or field/extension.py in one
// launch.
//
// Bound on the H100: HBM bytes (each operand read once, each output written
// once: 24 bytes an element for a binary op, 48 for an extension product)
// at 3.35 TB/s; a base product is four 32x32->64-bit multiplies, far below
// the integer rate.  What the design does about it: one element a thread in
// a grid-stride loop, the operands read in place through their element
// strides (a stride of 0 broadcasts), so no expanded or strided copy is
// made, and the host side merges every pair of dimensions that all
// operands walk alike, which leaves most calls one-dimensional (no index
// division in the loop).
//
// Every entry returns the bit pattern of its torch version, not only the
// same residue: add, mul and reduce128 in goldilocks.cuh compute the torch
// algorithms' values, sub reduces b into [0, p) first as sub_torch does, and
// the extension ops make the torch versions' sequence of base ops.
//
// An entry takes its outputs, its inputs and a layout of 4 + 4 K int64s
// (K inputs): the output's shape padded on the left with 1s to rank 4, then
// each input's element strides in the output's four dimensions.  Outputs
// are contiguous and new; no output aliases an input.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int RANK = 4;
constexpr int MAX_IN = 4;
constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 8192;
constexpr uint64_t P = 0xFFFFFFFF00000001ull;

enum Op { ADD, SUB, MUL, NEG, CANONICAL, EXT_MUL, EXT_SQUARE };

template <int OP>
struct Arity {
  static constexpr int in = (OP == NEG || OP == CANONICAL) ? 1
                            : (OP == EXT_MUL)             ? 4
                                                          : 2;
  static constexpr int out = (OP == EXT_MUL || OP == EXT_SQUARE) ? 2 : 1;
};

struct Args {
  uint64_t* out[2];
  const uint64_t* in[MAX_IN];
  int64_t n[RANK];           // merged shape, n[0] outermost
  int64_t s[MAX_IN][RANK];   // element strides of each input
  int64_t total;
};

__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= P ? x - P : x;
}

// sub_torch: b into [0, p) first, then goldilocks.cuh's borrow fix-ups
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  return gl::sub(a, canonical(b));
}

__device__ __forceinline__ uint64_t neg(uint64_t a) {
  a = canonical(a);
  return a == 0 ? 0 : P - a;
}

// (a0 + a1 phi)(b0 + b1 phi), phi^2 = 7: extension.py mul_torch's steps
__device__ __forceinline__ void ext_mul(uint64_t a0, uint64_t a1, uint64_t b0,
                                        uint64_t b1, uint64_t& c0,
                                        uint64_t& c1) {
  c0 = gl::add(gl::mul(a0, b0), gl::mul(gl::mul(a1, b1), 7));
  c1 = gl::add(gl::mul(a0, b1), gl::mul(a1, b0));
}

__device__ __forceinline__ void ext_square(uint64_t a0, uint64_t a1,
                                           uint64_t& c0, uint64_t& c1) {
  const uint64_t ab = gl::mul(a0, a1);
  c0 = gl::add(gl::mul(a0, a0), gl::mul(gl::mul(a1, a1), 7));
  c1 = gl::add(ab, ab);
}

// R: the merged rank (1-4).  Offsets are 64-bit; a rank above 1 splits the
// flat index by the inner sizes.
template <int OP, int R>
__global__ void __launch_bounds__(THREADS) field_kernel(const Args A) {
  constexpr int K = Arity<OP>::in;
  const int64_t step = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < A.total;
       i += step) {
    int64_t off[K];
    int64_t rem = i;
#pragma unroll
    for (int k = 0; k < K; ++k) off[k] = 0;
#pragma unroll
    for (int d = R - 1; d > 0; --d) {
      const int64_t q = rem / A.n[d];
      const int64_t c = rem - q * A.n[d];
      rem = q;
#pragma unroll
      for (int k = 0; k < K; ++k) off[k] += c * A.s[k][d];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) off[k] += rem * A.s[k][0];
    uint64_t x[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[k] = __ldg((const unsigned long long*)A.in[k] + off[k]);
    if constexpr (OP == ADD) A.out[0][i] = gl::add(x[0], x[1]);
    if constexpr (OP == SUB) A.out[0][i] = sub(x[0], x[1]);
    if constexpr (OP == MUL) A.out[0][i] = gl::mul(x[0], x[1]);
    if constexpr (OP == NEG) A.out[0][i] = neg(x[0]);
    if constexpr (OP == CANONICAL) A.out[0][i] = canonical(x[0]);
    if constexpr (OP == EXT_MUL) {
      uint64_t c0, c1;
      ext_mul(x[0], x[1], x[2], x[3], c0, c1);
      A.out[0][i] = c0;
      A.out[1][i] = c1;
    }
    if constexpr (OP == EXT_SQUARE) {
      uint64_t c0, c1;
      ext_square(x[0], x[1], c0, c1);
      A.out[0][i] = c0;
      A.out[1][i] = c1;
    }
  }
}

// Drops dimensions of size 1 and merges each dimension into the one outside
// it where every input steps across both alike (outer stride = inner stride
// * inner size; the contiguous output always does); returns the merged rank,
// at least 1.
template <int K>
int merge_dims(const int64_t* layout, Args& A) {
  int r = 0;
  for (int d = 0; d < RANK; ++d) {
    const int64_t n = layout[d];
    if (n == 1) continue;
    bool merge = r > 0;
    for (int k = 0; k < K && merge; ++k)
      merge = A.s[k][r - 1] == layout[RANK + k * RANK + d] * n;
    if (merge) {
      A.n[r - 1] *= n;
    } else {
      A.n[r] = n;
      ++r;
    }
    for (int k = 0; k < K; ++k) A.s[k][r - 1] = layout[RANK + k * RANK + d];
  }
  if (r == 0) {
    A.n[0] = 1;
    for (int k = 0; k < K; ++k) A.s[k][0] = 0;
    r = 1;
  }
  return r;
}

template <int OP>
int launch(void* const* outs, const void* const* ins, const int64_t* layout,
           int* launches, void* stream) {
  constexpr int K = Arity<OP>::in;
  *launches = 0;
  Args A = {};
  for (int j = 0; j < Arity<OP>::out; ++j) A.out[j] = (uint64_t*)outs[j];
  for (int k = 0; k < K; ++k) A.in[k] = (const uint64_t*)ins[k];
  A.total = 1;
  for (int d = 0; d < RANK; ++d) {
    if (layout[d] < 0) return (int)cudaErrorInvalidValue;
    A.total *= layout[d];
  }
  if (A.total == 0) return (int)cudaGetLastError();
  const int r = merge_dims<K>(layout, A);
  int64_t blocks = (A.total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
    case 1: field_kernel<OP, 1><<<grid, THREADS, 0, st>>>(A); break;
    case 2: field_kernel<OP, 2><<<grid, THREADS, 0, st>>>(A); break;
    case 3: field_kernel<OP, 3><<<grid, THREADS, 0, st>>>(A); break;
    default: field_kernel<OP, 4><<<grid, THREADS, 0, st>>>(A); break;
  }
  *launches = 1;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gl_add(void* out, const void* a, const void* b,
                      const int64_t* layout, int* launches, void* stream) {
  void* outs[] = {out};
  const void* ins[] = {a, b};
  return launch<ADD>(outs, ins, layout, launches, stream);
}

extern "C" int gl_sub(void* out, const void* a, const void* b,
                      const int64_t* layout, int* launches, void* stream) {
  void* outs[] = {out};
  const void* ins[] = {a, b};
  return launch<SUB>(outs, ins, layout, launches, stream);
}

extern "C" int gl_mul(void* out, const void* a, const void* b,
                      const int64_t* layout, int* launches, void* stream) {
  void* outs[] = {out};
  const void* ins[] = {a, b};
  return launch<MUL>(outs, ins, layout, launches, stream);
}

extern "C" int gl_neg(void* out, const void* a, const int64_t* layout,
                      int* launches, void* stream) {
  void* outs[] = {out};
  const void* ins[] = {a};
  return launch<NEG>(outs, ins, layout, launches, stream);
}

extern "C" int gl_canonical(void* out, const void* a, const int64_t* layout,
                            int* launches, void* stream) {
  void* outs[] = {out};
  const void* ins[] = {a};
  return launch<CANONICAL>(outs, ins, layout, launches, stream);
}

// (c0, c1) = (a0 + a1 phi)(b0 + b1 phi)
extern "C" int gl2_mul(void* c0, void* c1, const void* a0, const void* a1,
                       const void* b0, const void* b1, const int64_t* layout,
                       int* launches, void* stream) {
  void* outs[] = {c0, c1};
  const void* ins[] = {a0, a1, b0, b1};
  return launch<EXT_MUL>(outs, ins, layout, launches, stream);
}

// (c0, c1) = (a0 + a1 phi)^2
extern "C" int gl2_square(void* c0, void* c1, const void* a0, const void* a1,
                          const int64_t* layout, int* launches, void* stream) {
  void* outs[] = {c0, c1};
  const void* ins[] = {a0, a1};
  return launch<EXT_SQUARE>(outs, ins, layout, launches, stream);
}
