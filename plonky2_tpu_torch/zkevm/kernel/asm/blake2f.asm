// BLAKE2b F compression + the 0x09 precompile (EIP-152; twin of
// reference cpu/kernel/asm/hash/blake2b + core/precompiles/blake2_f,
// re-targeted at the word machine: 64-bit lane arithmetic on the
// 256-bit ALU with explicit masking).
//
// Input (213 bytes at BYTES[ao]): rounds (4, BE) || h (64, LE words)
// || m (128, LE words) || t0 (8, LE) || t1 (8, LE) || f (1).
// Output: the new h (64 bytes, LE words).  A final-block flag other
// than 0/1 PANICs (the reference errors the call).
//
// State in fresh TRIE cells at @GLOBAL_SHA_BASE (reused scratch):
//   +0..15  v[0..15]   +16..31 m[0..15]   +32..39 h[0..7]
//   +40 bsw  +41 ao  +42 rounds  +43 t0  +44 t1  +45 f
// The SIGMA schedule is 10 WORDS, 16 nibbles each (msb = index 0).
// Stack comments list the TOP first.

%macro b2_load(slot)
    %mload_global(@GLOBAL_SHA_BASE)
    PUSH $slot
    ADD
    %trie_read
%endmacro

%macro b2_store(slot)            // [value, ..] -> [..]
    %mload_global(@GLOBAL_SHA_BASE)
    PUSH $slot
    ADD
    %trie_write
%endmacro

%macro b2_v_read                 // [i, ..] -> [v[i], ..]
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    %trie_read
%endmacro

%macro b2_v_write                // [i, x, ..] -> [..]
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    %trie_write
%endmacro

%macro b2_m_read                 // [i, ..] -> [m[i], ..]
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    PUSH 16
    ADD
    %trie_read
%endmacro

%macro rotr64                    // [x, n, ..] -> [rotr64(x, n), ..]
    DUP2
    DUP2
    SWAP1                        // [n, x, x, n]
    SHR                          // [x >> n, x, n]
    %stack (lo, x, n) -> (64, n, x, lo)
    SUB                          // [64-n, x, lo]
    SHL
    OR
    PUSH 0xffffffffffffffff
    AND
%endmacro

%macro add64                     // [a, b, ..] -> [(a+b) mod 2^64, ..]
    ADD
    PUSH 0xffffffffffffffff
    AND
%endmacro

// b2_le64(k, retdest) -> w: little-endian 8-byte word at BYTES[ao+k]
global b2_le64:
    // stack: k, retdest
    %b2_load(41)
    ADD                          // [base = ao+k, retdest]
    PUSH 8
    PUSH 0                       // [acc, 8, base, retdest]
    SWAP1                        // [j=8, acc, base, retdest]
b2l_loop:
    // stack: j, acc, base, retdest — msb-first over bytes 7..0
    DUP1
    ISZERO
    %jumpi(b2l_done)
    PUSH 1
    SWAP1
    SUB                          // [j-1, acc, base, retdest]
    %stack (j, acc) -> (8, acc, j)
    SHL                          // [acc<<8, j, base, retdest]
    DUP2
    DUP4
    ADD                          // [base+j, acc', j, base, retdest]
    %b2_load(40)                 // [bsw, addr, acc', j, base, retdest]
    MLOAD_GENERAL                // [b, acc', j, base, retdest]
    OR                           // [acc'', j, base, retdest]
    SWAP1
    %jump(b2l_loop)
b2l_done:
    // stack: j(0), acc, base, retdest
    %stack (j, acc, base, retdest) -> (retdest, acc)
    JUMP

// b2_g(a, b, c, d, x, y, retdest): one G mixing step on v-cells a..d
// with message words x, y.
global b2_g:
    // stack: a, b, c, d, x, y, retdest
    // v[a] = v[a] + v[b] + x
    DUP2
    %b2_v_read
    DUP2
    %b2_v_read
    %add64
    DUP6
    %add64                       // [va', a, b, c, d, x, y, r]
    DUP2
    %b2_v_write                  // [a, b, c, d, x, y, r]
    // v[d] = rotr64(v[d] ^ v[a], 32)
    DUP4
    %b2_v_read
    DUP2
    %b2_v_read
    XOR
    PUSH 32
    SWAP1
    %rotr64                      // [vd', a, b, c, d, x, y, r]
    DUP5
    %b2_v_write
    // v[c] = v[c] + v[d]
    DUP3
    %b2_v_read
    DUP5
    %b2_v_read
    %add64
    DUP4
    %b2_v_write
    // v[b] = rotr64(v[b] ^ v[c], 24)
    DUP2
    %b2_v_read
    DUP4
    %b2_v_read
    XOR
    PUSH 24
    SWAP1
    %rotr64
    DUP3
    %b2_v_write
    // v[a] = v[a] + v[b] + y
    DUP2
    %b2_v_read
    DUP2
    %b2_v_read
    %add64
    DUP7
    %add64
    DUP2
    %b2_v_write
    // v[d] = rotr64(v[d] ^ v[a], 16)
    DUP4
    %b2_v_read
    DUP2
    %b2_v_read
    XOR
    PUSH 16
    SWAP1
    %rotr64
    DUP5
    %b2_v_write
    // v[c] = v[c] + v[d]
    DUP3
    %b2_v_read
    DUP5
    %b2_v_read
    %add64
    DUP4
    %b2_v_write
    // v[b] = rotr64(v[b] ^ v[c], 63)
    DUP2
    %b2_v_read
    DUP4
    %b2_v_read
    XOR
    PUSH 63
    SWAP1
    %rotr64
    DUP3
    %b2_v_write
    %stack (a, b, c, d, x, y, retdest) -> (retdest)
    JUMP

// [r, i] -> [SIGMA[r % 10][i]]: nibble i (msb-first) of schedule row r
%macro b2_sigma
    // stack: r, i
    PUSH 10
    SWAP1
    MOD                          // [r%10, i]
    PUSH b2_sigma_rows
    ADD
    DUP1
    ADD
    PUSH 1
    ADD
    PUSH @SEGMENT_CODE
    MLOAD_GENERAL                // [row, i]
    SWAP1
    PUSH 15
    SUB                          // [15-i, row]
    PUSH 2
    SHL                          // [4*(15-i), row]
    SHR                          // [row >> 4(15-i)]
    PUSH 0xf
    AND
%endmacro

// blake2f_compress(retdest): state cells prepared; runs `rounds`
// rounds and writes h' back to cells 32..39.
global blake2f_compress:
    // v[0..7] = h, v[8..15] = IV
    PUSH 0
b2i_h:
    DUP1
    PUSH 8
    EQ
    %jumpi(b2i_hd)
    DUP1
    PUSH 32
    ADD
    %b2_v_read                   // [h_i, i, retdest]
    DUP2
    %b2_v_write                  // v[i] = h_i
    PUSH 1
    ADD
    %jump(b2i_h)
b2i_hd:
    POP
    PUSH 0x6a09e667f3bcc908
    PUSH 8
    %b2_v_write
    PUSH 0xbb67ae8584caa73b
    PUSH 9
    %b2_v_write
    PUSH 0x3c6ef372fe94f82b
    PUSH 10
    %b2_v_write
    PUSH 0xa54ff53a5f1d36f1
    PUSH 11
    %b2_v_write
    // v[12] ^= t0, v[13] ^= t1
    %b2_load(43)
    PUSH 0x510e527fade682d1
    XOR
    PUSH 12
    %b2_v_write
    %b2_load(44)
    PUSH 0x9b05688c2b3e6c1f
    XOR
    PUSH 13
    %b2_v_write
    // v[14] ^= 0xfff..f when f = 1
    %b2_load(45)
    ISZERO
    %jumpi(b2i_nf)
    PUSH 0xe07c265404be4294
    %jump(b2i_f)
b2i_nf:
    PUSH 0x1f83d9abfb41bd6b
b2i_f:
    PUSH 14
    %b2_v_write
    PUSH 0x5be0cd19137e2179
    PUSH 15
    %b2_v_write
    // rounds
    PUSH 0                       // [r, retdest]
b2r:
    %b2_load(42)
    DUP2
    EQ
    %jumpi(b2r_done)
    // column steps: G(0,4,8,12,s0,s1) G(1,5,9,13,s2,s3)
    //               G(2,6,10,14,s4,s5) G(3,7,11,15,s6,s7)
    // diagonal:     G(0,5,10,15,s8,s9) G(1,6,11,12,s10,s11)
    //               G(2,7,8,13,s12,s13) G(3,4,9,14,s14,s15)
    %b2_round
    PUSH 1
    ADD
    %jump(b2r)
b2r_done:
    POP
    // h'[i] = h[i] ^ v[i] ^ v[i+8]
    PUSH 0
b2o:
    DUP1
    PUSH 8
    EQ
    %jumpi(b2o_done)
    DUP1
    %b2_v_read
    DUP2
    PUSH 8
    ADD
    %b2_v_read
    XOR                          // [v_i ^ v_{i+8}, i, retdest]
    DUP2
    PUSH 32
    ADD
    %b2_v_read
    XOR                          // [h_i', i, retdest]
    DUP2
    PUSH 32
    ADD
    %b2_v_write                  // h[i] = h_i'
    PUSH 1
    ADD
    %jump(b2o)
b2o_done:
    POP
    JUMP

// one full round r (stack: r, ... preserved): 8 G steps with the
// SIGMA schedule of row r
%macro b2_g_step(a, b, c, d, i0, i1)
    DUP1
    PUSH $i0
    SWAP1
    %b2_sigma
    %b2_m_read                   // [x, r, ..]
    DUP2
    PUSH $i1
    SWAP1
    %b2_sigma
    %b2_m_read                   // [y, x, r, ..]
    %stack (y, x) -> ($a, $b, $c, $d, x, y, %%gd)
    %jump(b2_g)
%%gd:
%endmacro

%macro b2_round
    %b2_g_step(0, 4, 8, 12, 0, 1)
    %b2_g_step(1, 5, 9, 13, 2, 3)
    %b2_g_step(2, 6, 10, 14, 4, 5)
    %b2_g_step(3, 7, 11, 15, 6, 7)
    %b2_g_step(0, 5, 10, 15, 8, 9)
    %b2_g_step(1, 6, 11, 12, 10, 11)
    %b2_g_step(2, 7, 8, 13, 12, 13)
    %b2_g_step(3, 4, 9, 14, 14, 15)
%endmacro

// ---- 0x09 precompile
global pc_blake2f:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    // exact input size (EIP-152: not 213 bytes -> error)
    DUP4
    PUSH 213
    EQ
    ISZERO
    %jumpi(panic)
    PUSH 46
    %trie_alloc
    %mstore_global(@GLOBAL_SHA_BASE)
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)
    %b2_store(40)                // bsw
    DUP3
    %b2_store(41)                // ao
    // rounds: 4 BE bytes at +0
    %b2_load(40)
    DUP4
    %stack (ao, bsw) -> (bsw, ao, 4, pb2_1)
    %jump(mload_be_gen)
pb2_1:
    // stack: rounds, trap, value, ao, asz, ro, rs
    %b2_store(42)
    // h[0..7] at +4, LE
    PUSH 0                       // [i, trap, ...]
pb2_h:
    DUP1
    PUSH 8
    EQ
    %jumpi(pb2_hd)
    DUP1
    PUSH 3
    SHL
    PUSH 4
    ADD                          // [4+8i, i, trap, ...]
    %stack (k) -> (k, pb2_h1)
    %jump(b2_le64)
pb2_h1:
    // stack: w, i, trap, ...
    DUP2
    PUSH 32
    ADD
    %b2_v_write                  // h cell 32+i
    PUSH 1
    ADD
    %jump(pb2_h)
pb2_hd:
    POP
    // m[0..15] at +68, LE
    PUSH 0
pb2_m:
    DUP1
    PUSH 16
    EQ
    %jumpi(pb2_md)
    DUP1
    PUSH 3
    SHL
    PUSH 68
    ADD
    %stack (k) -> (k, pb2_m1)
    %jump(b2_le64)
pb2_m1:
    DUP2
    PUSH 16
    ADD
    %b2_v_write                  // m cell 16+i
    PUSH 1
    ADD
    %jump(pb2_m)
pb2_md:
    POP
    // t0 at +196, t1 at +204 (LE), f at +212
    PUSH 196
    %stack (k) -> (k, pb2_t0)
    %jump(b2_le64)
pb2_t0:
    %b2_store(43)
    PUSH 204
    %stack (k) -> (k, pb2_t1)
    %jump(b2_le64)
pb2_t1:
    %b2_store(44)
    %b2_load(41)
    PUSH 212
    ADD
    %b2_load(40)
    MLOAD_GENERAL                // [f, trap, ...]
    DUP1
    PUSH 2
    SWAP1
    LT                           // [f < 2, f, trap, ...]
    ISZERO
    %jumpi(panic)
    %b2_store(45)
    PUSH pb2_c
    %jump(blake2f_compress)
pb2_c:
    // output: h cells 32..39 as 64 LE bytes of RETURNDATA
    PUSH 0                       // [i, trap, ...]
pb2_o:
    DUP1
    PUSH 8
    EQ
    %jumpi(pb2_od)
    DUP1
    PUSH 32
    ADD
    %b2_v_read                   // [h_i, i, trap, ...]
    // 8 LE bytes at RETURNDATA[8i..8i+8)
    PUSH 0                       // [j, h_i, i, trap, ...]
pb2_ob:
    DUP1
    PUSH 8
    EQ
    %jumpi(pb2_obd)
    DUP2
    PUSH 0xff
    AND                          // [b, j, h, i, trap, ...]
    DUP2
    DUP5
    PUSH 3
    SHL
    ADD                          // [8i+j, b, j, h, i, trap, ...]
    PUSH @SEGMENT_RETURNDATA
    MSTORE_GENERAL               // [j, h, i, trap, ...]
    SWAP1
    PUSH 8
    SHR                          // [h>>8, j, i, trap, ...]
    SWAP1
    PUSH 1
    ADD
    %jump(pb2_ob)
pb2_obd:
    // stack: j(8), h(0-ish), i, trap, ...
    POP
    POP
    PUSH 1
    ADD
    %jump(pb2_o)
pb2_od:
    POP
    PUSH 64
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %jump(pc_done)

b2_sigma_rows:
    WORDS 0x0123456789abcdef 0xea489fd61c02b753 0xb8c052fdae367194 0x7931dcbe265a40f8 0x905724afe1bc683d
    WORDS 0x2c6a0b834d75fe19 0xc51fed4a0763928b 0xdb7ec13950f4862a 0x6fe9b308c2d714a5 0xa2847615fb9e3cd0
