// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for CUDA device code.
//
// Values are u64 residues, kept noncanonical (any u64 stands for its
// residue mod p) exactly as the torch plain versions and the host twin
// field/gl64.py keep them; canon() normalises into [0, p).  The algorithms
// are the reference's (field/src/goldilocks_field.rs:346-390): 2^64 = EPS
// and 2^96 = -1 mod p, with branch-free carry fix-ups.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t x) {
  return x >= P ? x - P : x;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  uint64_t s2 = s + (s < a ? EPS : 0);
  return s2 + (s2 < s ? EPS : 0);  // a second wrap only after a first one
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  b = canon(b);
  uint64_t d = a - b;
  // a < b: d = a - b + 2^64 > 2^64 - p = EPS, so one EPS fix-up is exact
  return d - (a < b ? EPS : 0);
}

// (hi * 2^64 + lo) mod p
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  uint64_t t1 = hi_lo * EPS;           // < 2^64
  uint64_t t2 = t0 + t1;
  return t2 + (t2 < t1 ? EPS : 0);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

}  // namespace gl
