// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for CUDA device code.
//
// Values are u64 residues, kept noncanonical (any u64 stands for its
// residue mod p) exactly as the torch plain versions and the host twin
// field/gl64.py keep them.  The algorithms are the reference's
// (field/src/goldilocks_field.rs:346-390): 2^64 = EPS and 2^96 = -1 mod p,
// with branch-free carry fix-ups.
//
// Hopper has no 64x64-bit multiplier: a 64-bit product is built from
// 32x32->64-bit IMAD.WIDE.U32 instructions, each of which also adds a
// 64-bit operand.  mul128 uses exactly four of them and folds the
// cross-term carries into their addends, where a * b plus __umul64hi(a, b)
// would spend seven.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

// Carries and borrows are read from the carry flag of 32-bit limb
// arithmetic (PTX add.cc/addc, sub.cc/subc) instead of being recomputed by
// 64-bit compares and selects: 8-13 instructions per operation.

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 c;\n\t"
      "add.cc.u32 %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"           // a carry is 2^64 = EPS: add EPS
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"           // a second wrap only after a first one
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)));
  return ((uint64_t)r1 << 32) | r0;
}

// a - b: each borrow is -2^64 = -EPS, so subtract EPS; a second borrow
// only when b >= p, and then no third.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "sub.cc.u32 %0, %2, %4;\n\t"
      "subc.cc.u32 %1, %3, %5;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b),
        "r"((uint32_t)(b >> 32)));
  return ((uint64_t)r1 << 32) | r0;
}

// (hi * 2^64 + lo) mod p = lo - hi_hi + hi_lo * EPS (2^96 = -1)
__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 t0, t1, m, u0, u1;\n\t"
      "sub.cc.u32 t0, %2, %5;\n\t"    // t = lo - hi_hi
      "subc.cc.u32 t1, %3, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "sub.cc.u32 t0, t0, m;\n\t"     // a borrow: subtract EPS (no 2nd)
      "subc.u32 t1, t1, 0;\n\t"
      "sub.cc.u32 u0, 0, %4;\n\t"     // u = hi_lo * EPS
      "subc.u32 u1, %4, 0;\n\t"
      "add.cc.u32 %0, t0, u0;\n\t"    // r = t + u
      "addc.cc.u32 %1, t1, u1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"             // a carry: add EPS (no 2nd)
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "r"((uint32_t)lo), "r"((uint32_t)(lo >> 32)), "r"((uint32_t)hi),
        "r"((uint32_t)(hi >> 32)));
  return ((uint64_t)r1 << 32) | r0;
}


// The full 128-bit product a * b: four 32x32->64-bit products, each
// carrying the previous one's high half in its addend (no sum overflows:
// (2^32 - 1)^2 + 2 (2^32 - 1) = 2^64 - 1).
__device__ __forceinline__ void mul128(uint64_t a, uint64_t b, uint64_t& hi,
                                       uint64_t& lo) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
  const uint64_t t = (uint64_t)a0 * b0;
  const uint64_t m1 = (uint64_t)a0 * b1 + (t >> 32);
  const uint64_t m2 = (uint64_t)a1 * b0 + (uint32_t)m1;
  hi = (uint64_t)a1 * b1 + (m1 >> 32) + (m2 >> 32);
  lo = (m2 << 32) | (uint32_t)t;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t hi, lo;
  mul128(a, b, hi, lo);
  return reduce128(hi, lo);
}

// (a * b + c) mod p with one reduction: the 128-bit product plus c.
__device__ __forceinline__ uint64_t mul_add(uint64_t a, uint64_t b,
                                            uint64_t c) {
  uint64_t hi, lo;
  mul128(a, b, hi, lo);
  lo += c;
  hi += lo < c;  // hi <= 2^64 - 2 for any product, so this cannot wrap
  return reduce128(hi, lo);
}

// (hi * 2^32 + lo) mod p for hi, lo < 2^43: the sums of small-constant
// products of 32-bit halves that an MDS layer accumulates.
__device__ __forceinline__ uint64_t reduce_halves(uint64_t lo, uint64_t hi) {
  const uint64_t l = lo + (hi << 32);
  const uint64_t top = (hi >> 32) + (l < lo);  // < 2^12: the 2^64 digit
  const uint64_t r = l + top * EPS;            // 2^64 = EPS
  return r + (r < l ? EPS : 0);
}

}  // namespace gl
