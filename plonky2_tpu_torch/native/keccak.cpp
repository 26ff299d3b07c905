// Native keccak-f[1600] + batched keccak-256 for the host-side hashing of
// KeccakGoldilocksConfig (hash/keccak_tree.py): Merkle leaf/level hashing is
// host work by design (the keccak config exists for host-cheap non-recursive
// proofs, reference plonky2/src/plonk/config.rs:72), so it gets the native
// treatment the reference gets from rustc.  Exposed via ctypes
// (native/__init__.py, which builds it into the package's _build/ directory);
// the numpy twins in hash/keccak.py remain the fallback and the cross-check.
//
// Build: g++ -O3 -shared -fPIC keccak.cpp -o libkeccak.so

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rotation offsets indexed [x][y] to match the (y, x) lane layout used by
// hash/keccak.py (state[y][x] = lane (x, y)).
constexpr int ROT[5][5] = {
    {0, 36, 3, 41, 18},
    {1, 44, 10, 45, 2},
    {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56},
    {27, 20, 39, 8, 14},
};

inline uint64_t rotl(uint64_t v, int n) {
  n &= 63;
  return n ? (v << n) | (v >> (64 - n)) : v;
}

// One permutation of a 25-lane state, flat index s[5*y + x].
inline void permute(uint64_t *s) {
  uint64_t b[25];
  for (int r = 0; r < 24; ++r) {
    // theta
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = s[x] ^ s[5 + x] ^ s[10 + x] ^ s[15 + x] ^ s[20 + x];
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x) s[5 * y + x] ^= d[x];
    // rho + pi: b[(2x+3y)%5][y] = rotl(s[y][x])
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[5 * ((2 * x + 3 * y) % 5) + y] = rotl(s[5 * y + x], ROT[x][y]);
    // chi
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        s[5 * y + x] = b[5 * y + x] ^ (~b[5 * y + (x + 1) % 5] &
                                       b[5 * y + (x + 2) % 5]);
    // iota
    s[0] ^= RC[r];
  }
}

constexpr size_t RATE = 136;  // keccak-256 rate in bytes

// keccak-256 (pre-NIST 0x01 padding) of one message into out[0..32).
inline void hash_one(const uint8_t *msg, size_t len, uint8_t *out) {
  uint64_t s[25] = {0};
  size_t off = 0;
  // full blocks
  for (; off + RATE <= len; off += RATE) {
    uint64_t lanes[17];
    std::memcpy(lanes, msg + off, RATE);
    for (int i = 0; i < 17; ++i) s[i] ^= lanes[i];
    permute(s);
  }
  // final (padded) block (guard the memcpy: msg may be a null/invalid
  // pointer for zero-length inputs, and memcpy(dst, NULL, 0) is UB that
  // -O3 exploits)
  uint8_t last[RATE] = {0};
  if (len - off) std::memcpy(last, msg + off, len - off);
  last[len - off] ^= 0x01;
  last[RATE - 1] ^= 0x80;
  uint64_t lanes[17];
  std::memcpy(lanes, last, RATE);
  for (int i = 0; i < 17; ++i) s[i] ^= lanes[i];
  permute(s);
  std::memcpy(out, s, 32);
}

}  // namespace

extern "C" {

// In-place keccak-f[1600] over n states of 25 little-endian u64 lanes each
// (flat (x, y) order matching hash/keccak.py's (..., 5, 5) reshape).
void keccak_f_batch(uint64_t *states, size_t n) {
  for (size_t i = 0; i < n; ++i) permute(states + 25 * i);
}

// keccak-256 of each row of an (n, len) contiguous byte matrix -> (n, 32).
void keccak256_rows(const uint8_t *rows, size_t n, size_t len, uint8_t *out) {
  for (size_t i = 0; i < n; ++i) hash_one(rows + i * len, len, out + 32 * i);
}

// Merkle 2-to-1 layer: digests of size `size` bytes, n output rows; child
// pairs are rows (2i, 2i+1) of `level`, output row i = keccak256(pair)[:size].
void keccak_merkle_layer(const uint8_t *level, size_t n, size_t size,
                         uint8_t *out) {
  if (size == 0 || size > 32) return;  // cat[] holds two <=32-byte digests
  for (size_t i = 0; i < n; ++i) {
    uint8_t cat[2 * 32];
    std::memcpy(cat, level + 2 * i * size, 2 * size);
    uint8_t digest[32];
    hash_one(cat, 2 * size, digest);
    std::memcpy(out + i * size, digest, size);
  }
}

}  // extern "C"
