// RIPEMD-160 + the 0x03 precompile (twin of reference
// cpu/kernel/asm/hash/ripemd/{main,box,constants}.asm +
// core/precompiles/rip160.asm, re-targeted at the word machine like
// sha256.asm: 32-bit lane arithmetic on the 256-bit ALU with explicit
// masking).  Unlike SHA-256, RIPEMD-160 is little-endian throughout:
// message words load LE, the length tail is LE, and the digest is the
// LE byte dump of h0..h4.
//
// The per-line index (r), rotation (s) and round-constant (K) tables
// live as WORDS blocks (immediate words of the kernel image, read back
// through SEG_CODE at 2*(label + i) + 1).  Per-call state uses fresh
// TRIE cells at @GLOBAL_RIPEMD_BASE:
//   +0..4   running h0..h4           +5..9   working A..E (current line)
//   +10 padded length  +11 input offset  +12 input segword  +13 nbytes
//   +14..29 block words X[0..15]     +30..34 left-line result a1..e1
//   +35 r-table base  +36 s-table base  +37 K base  +38 line flag
// Stack comments list the TOP first.

%macro rmd_load(slot)
    %mload_global(@GLOBAL_RIPEMD_BASE)
    PUSH $slot
    ADD
    %trie_read
%endmacro

%macro rmd_store(slot)           // [value, ..] -> [..]
    %mload_global(@GLOBAL_RIPEMD_BASE)
    PUSH $slot
    ADD
    %trie_write
%endmacro

%macro rotl32                    // [x, n, ..] -> [rotl32(x, n), ..]
    DUP2
    DUP2
    SWAP1                        // [n, x, x, n]
    SHL                          // [x << n, x, n]
    %stack (hi, x, n) -> (32, n, x, hi)
    SUB                          // [32-n, x, hi]
    SHR                          // [x >> (32-n), hi]
    OR
    PUSH 0xffffffff
    AND
%endmacro

%macro bswap4                    // [x, ..] -> [4-byte byte-reverse, ..]
    PUSH 0xff
    DUP2
    AND                          // [b0, x]
    SWAP1
    PUSH 8
    SHR                          // [x>>8, b0]
    PUSH 0xff
    DUP2
    AND                          // [b1, x1, b0]
    SWAP1
    PUSH 8
    SHR                          // [x2, b1, b0]
    PUSH 0xff
    DUP2
    AND                          // [b2, x2, b1, b0]
    SWAP1
    PUSH 8
    SHR
    PUSH 0xff
    AND                          // [b3, b2, b1, b0]
    SWAP1
    PUSH 8
    SHL
    OR                           // [b2<<8 | b3, b1, b0]
    SWAP1
    PUSH 16
    SHL
    OR                           // [b1<<16 | .., b0]
    SWAP1
    PUSH 24
    SHL
    OR                           // [b0<<24 | b1<<16 | b2<<8 | b3]
%endmacro

// rmd_pad_byte(i, retdest) -> b: byte i of the MD4-family-padded
// message (data, 0x80, zeros, 64-bit LITTLE-endian bit length).
global rmd_pad_byte:
    // stack: i, retdest
    %rmd_load(13)
    DUP2
    LT                           // [i < nbytes, i, retdest]
    %jumpi(rpb_data)
    DUP1
    %rmd_load(13)
    EQ
    %jumpi(rpb_80)
    %rmd_load(10)
    PUSH 8
    SWAP1
    SUB                          // [plen-8, i, retdest]
    DUP2
    LT                           // [i < plen-8, i, retdest]
    %jumpi(rpb_zero)
    // length tail: k = i - (plen-8); byte = (bitlen >> 8k) & 0xff
    %rmd_load(10)
    PUSH 8
    SWAP1
    SUB
    SWAP1
    SUB                          // [k, retdest]
    PUSH 3
    SHL                          // [8k, retdest]
    %rmd_load(13)
    PUSH 3
    SHL                          // [bitlen, 8k, retdest]
    SWAP1
    SHR                          // [bitlen >> 8k, retdest]
    PUSH 0xff
    AND
    SWAP1
    JUMP
rpb_data:
    // stack: i, retdest
    %rmd_load(11)
    ADD                          // [offset+i, retdest]
    %rmd_load(12)                // [bsw, addr, retdest]
    MLOAD_GENERAL                // [b, retdest]
    SWAP1
    JUMP
rpb_80:
    %stack (i, retdest) -> (retdest, 0x80)
    JUMP
rpb_zero:
    %stack (i, retdest) -> (retdest, 0)
    JUMP

// rmd_run_line(retdest): 80 steps of one line over X[0..15]; the
// caller preset cells 35..38 (r/s/K table bases + line flag).  A..E
// start from h0..h4 and hold the line result on return.
global rmd_run_line:
    // stack: retdest
    %rmd_load(0)
    %rmd_store(5)
    %rmd_load(1)
    %rmd_store(6)
    %rmd_load(2)
    %rmd_store(7)
    %rmd_load(3)
    %rmd_store(8)
    %rmd_load(4)
    %rmd_store(9)
    PUSH 0                       // [j, retdest]
rstep:
    DUP1
    PUSH 80
    EQ
    %jumpi(rline_done)
    // f index: round j>>4 on the left line, 4 - (j>>4) on the right
    DUP1
    PUSH 4
    SHR                          // [fidx, j, retdest]
    %rmd_load(38)
    ISZERO
    %jumpi(rst_fsel)
    PUSH 4
    SUB                          // [4 - fidx, j, retdest]
rst_fsel:
    // stack: fidx, j, retdest — select f(B, C, D)
    DUP1
    ISZERO
    %jumpi(rf0)
    DUP1
    PUSH 1
    EQ
    %jumpi(rf1)
    DUP1
    PUSH 2
    EQ
    %jumpi(rf2)
    DUP1
    PUSH 3
    EQ
    %jumpi(rf3)
    // f4 = B ^ (C | ~D)
    POP
    %rmd_load(8)
    NOT
    PUSH 0xffffffff
    AND
    %rmd_load(7)
    OR
    %rmd_load(6)
    XOR
    %jump(rst_t)
rf0:
    // f0 = B ^ C ^ D
    POP
    %rmd_load(6)
    %rmd_load(7)
    XOR
    %rmd_load(8)
    XOR
    %jump(rst_t)
rf1:
    // f1 = (B & C) | (~B & D)
    POP
    %rmd_load(6)
    %rmd_load(7)
    AND
    %rmd_load(6)
    NOT
    PUSH 0xffffffff
    AND
    %rmd_load(8)
    AND
    OR
    %jump(rst_t)
rf2:
    // f2 = (B | ~C) ^ D
    POP
    %rmd_load(7)
    NOT
    PUSH 0xffffffff
    AND
    %rmd_load(6)
    OR
    %rmd_load(8)
    XOR
    %jump(rst_t)
rf3:
    // f3 = (B & D) | (C & ~D)
    POP
    %rmd_load(8)
    NOT
    PUSH 0xffffffff
    AND
    %rmd_load(7)
    AND
    %rmd_load(6)
    %rmd_load(8)
    AND
    OR
rst_t:
    // stack: f, j, retdest — T = rotl(A + f + X[r[j]] + K[j>>4], s[j]) + E
    %rmd_load(5)
    %add32                       // [A+f, j, retdest]
    DUP2
    %rmd_load(35)
    ADD
    DUP1
    ADD
    PUSH 1
    ADD
    PUSH @SEGMENT_CODE
    MLOAD_GENERAL                // [r_j, A+f, j, retdest]
    PUSH 14
    ADD
    %mload_global(@GLOBAL_RIPEMD_BASE)
    ADD
    %trie_read                   // [X[r_j], A+f, j, retdest]
    %add32
    DUP2
    PUSH 4
    SHR                          // [j>>4, sum, j, retdest]
    %rmd_load(37)
    ADD
    DUP1
    ADD
    PUSH 1
    ADD
    PUSH @SEGMENT_CODE
    MLOAD_GENERAL                // [K, sum, j, retdest]
    %add32                       // [T0, j, retdest]
    DUP2
    %rmd_load(36)
    ADD
    DUP1
    ADD
    PUSH 1
    ADD
    PUSH @SEGMENT_CODE
    MLOAD_GENERAL                // [s_j, T0, j, retdest]
    SWAP1                        // [T0, s_j, j, retdest]
    %rotl32                      // [T1, j, retdest]
    %rmd_load(9)
    %add32                       // [T, j, retdest]
    // (A, B, C, D, E) = (E, T, B, rotl(C, 10), D)
    %rmd_load(9)
    %rmd_store(5)                // A = E
    %rmd_load(8)
    %rmd_store(9)                // E = D
    %rmd_load(7)
    PUSH 10
    SWAP1                        // [C, 10, T, j, retdest]
    %rotl32
    %rmd_store(8)                // D = rotl(C, 10)
    %rmd_load(6)
    %rmd_store(7)                // C = B
    %rmd_store(6)                // B = T ; [j, retdest]
    PUSH 1
    ADD
    %jump(rstep)
rline_done:
    POP
    JUMP

// ripemd160(bsw, offset, nbytes, retdest) -> digest: the 20 digest
// bytes as one big-endian word (h0..h4 each dumped little-endian).
global ripemd160:
    // stack: bsw, offset, nbytes, retdest
    PUSH 40
    %trie_alloc
    %mstore_global(@GLOBAL_RIPEMD_BASE)
    %rmd_store(12)               // [offset, nbytes, retdest]
    %rmd_store(11)               // [nbytes, retdest]
    DUP1
    %rmd_store(13)
    PUSH 0x67452301
    %rmd_store(0)
    PUSH 0xefcdab89
    %rmd_store(1)
    PUSH 0x98badcfe
    %rmd_store(2)
    PUSH 0x10325476
    %rmd_store(3)
    PUSH 0xc3d2e1f0
    %rmd_store(4)
    // padded length = ((nbytes + 8) >> 6 + 1) << 6
    PUSH 8
    ADD
    PUSH 6
    SHR
    PUSH 1
    ADD
    PUSH 6
    SHL
    %rmd_store(10)               // [retdest]
    PUSH 0                       // [blk, retdest]
rmd_blocks:
    %rmd_load(10)
    DUP2
    EQ
    %jumpi(rmd_out)
    // ---- X[0..15]: 4 padded bytes each, LITTLE-endian
    PUSH 0                       // [t, blk, retdest]
rx16:
    DUP1
    PUSH 16
    EQ
    %jumpi(rx16_done)
    PUSH 0
    PUSH 0                       // [j, acc, t, blk, retdest]
rxb:
    DUP1
    PUSH 4
    EQ
    %jumpi(rxb_done)
    %stack (j, acc, t, blk) -> (4, t, blk, j, j, acc, t, blk)
    MUL
    ADD
    ADD                          // [i = 4t+blk+j, j, acc, t, blk, retdest]
    %stack (i) -> (i, rxb_1)
    %jump(rmd_pad_byte)
rxb_1:
    // stack: b, j, acc, t, blk, retdest — acc |= b << 8j
    DUP2
    PUSH 3
    SHL                          // [8j, b, j, acc, t, blk, retdest]
    SHL                          // [b << 8j, j, acc, t, blk, retdest]
    %stack (v, j, acc) -> (v, acc, j)
    OR                           // [acc', j, t, blk, retdest]
    SWAP1
    PUSH 1
    ADD
    %jump(rxb)
rxb_done:
    // stack: 4, acc, t, blk, retdest
    POP
    DUP2
    PUSH 14
    ADD
    %mload_global(@GLOBAL_RIPEMD_BASE)
    ADD
    %trie_write                  // X[t] = acc ; [t, blk, retdest]
    PUSH 1
    ADD
    %jump(rx16)
rx16_done:
    POP                          // [blk, retdest]
    // ---- left line
    PUSH rmd_rl
    %rmd_store(35)
    PUSH rmd_sl
    %rmd_store(36)
    PUSH rmd_kl
    %rmd_store(37)
    PUSH 0
    %rmd_store(38)
    PUSH rl_done
    %jump(rmd_run_line)
rl_done:
    %rmd_load(5)
    %rmd_store(30)
    %rmd_load(6)
    %rmd_store(31)
    %rmd_load(7)
    %rmd_store(32)
    %rmd_load(8)
    %rmd_store(33)
    %rmd_load(9)
    %rmd_store(34)
    // ---- right line
    PUSH rmd_rr
    %rmd_store(35)
    PUSH rmd_sr
    %rmd_store(36)
    PUSH rmd_kr
    %rmd_store(37)
    PUSH 1
    %rmd_store(38)
    PUSH rr_done
    %jump(rmd_run_line)
rr_done:
    // ---- combine: h = (h1+c1+d2, h2+d1+e2, h3+e1+a2, h4+a1+b2, h0+b1+c2)
    %rmd_load(1)
    %rmd_load(32)
    %add32
    %rmd_load(8)
    %add32                       // [T0, blk, retdest]
    %rmd_load(2)
    %rmd_load(33)
    %add32
    %rmd_load(9)
    %add32                       // [T1, T0, ..]
    %rmd_load(3)
    %rmd_load(34)
    %add32
    %rmd_load(5)
    %add32                       // [T2, T1, T0, ..]
    %rmd_load(4)
    %rmd_load(30)
    %add32
    %rmd_load(6)
    %add32                       // [T3, T2, T1, T0, ..]
    %rmd_load(0)
    %rmd_load(31)
    %add32
    %rmd_load(7)
    %add32                       // [T4, T3, T2, T1, T0, blk, retdest]
    %rmd_store(4)
    %rmd_store(3)
    %rmd_store(2)
    %rmd_store(1)
    %rmd_store(0)                // [blk, retdest]
    PUSH 64
    ADD
    %jump(rmd_blocks)
rmd_out:
    POP                          // [retdest]
    PUSH 0
    PUSH 0                       // [i, acc, retdest]
rdg:
    DUP1
    PUSH 5
    EQ
    %jumpi(rdg_done)
    %stack (i, acc) -> (32, acc, i)
    SHL                          // [acc<<32, i, retdest]
    DUP2
    %mload_global(@GLOBAL_RIPEMD_BASE)
    ADD
    %trie_read                   // [h_i, acc', i, retdest]
    %bswap4                      // little-endian byte dump of h_i
    OR
    SWAP1
    PUSH 1
    ADD
    %jump(rdg)
rdg_done:
    %stack (i, acc, retdest) -> (retdest, acc)
    JUMP

// ---- 0x03 precompile: 20-byte digest of BYTES[ao .. ao+asz),
// left-padded to 32 bytes (EVM output convention)
global pc_ripemd160:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, trap, value, ao, asz, ro, rs]
    %stack (bsw, trap, value, ao, asz) -> (bsw, ao, asz, prd_1, trap, value, ao, asz)
    %jump(ripemd160)
prd_1:
    // stack: digest, trap, value, ao, asz, ro, rs
    %stack (d) -> (@SEGMENT_RETURNDATA, 0, d, 32, prd_2)
    %jump(mstore_be_gen)
prd_2:
    PUSH 32
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %jump(pc_done)

// ---- tables (RIPEMD-160 spec, Dobbertin/Bosselaers/Preneel 1996)
rmd_rl:
    WORDS 0 1 2 3 4 5 6 7
    WORDS 8 9 10 11 12 13 14 15
    WORDS 7 4 13 1 10 6 15 3
    WORDS 12 0 9 5 2 14 11 8
    WORDS 3 10 14 4 9 15 8 1
    WORDS 2 7 0 6 13 11 5 12
    WORDS 1 9 11 10 0 8 12 4
    WORDS 13 3 7 15 14 5 6 2
    WORDS 4 0 5 9 7 12 2 10
    WORDS 14 1 3 8 11 6 15 13
rmd_rr:
    WORDS 5 14 7 0 9 2 11 4
    WORDS 13 6 15 8 1 10 3 12
    WORDS 6 11 3 7 0 13 5 10
    WORDS 14 15 8 12 4 9 1 2
    WORDS 15 5 1 3 7 14 6 9
    WORDS 11 8 12 2 10 0 4 13
    WORDS 8 6 4 1 3 11 15 0
    WORDS 5 12 2 13 9 7 10 14
    WORDS 12 15 10 4 1 5 8 7
    WORDS 6 2 13 14 0 3 9 11
rmd_sl:
    WORDS 11 14 15 12 5 8 7 9
    WORDS 11 13 14 15 6 7 9 8
    WORDS 7 6 8 13 11 9 7 15
    WORDS 7 12 15 9 11 7 13 12
    WORDS 11 13 6 7 14 9 13 15
    WORDS 14 8 13 6 5 12 7 5
    WORDS 11 12 14 15 14 15 9 8
    WORDS 9 14 5 6 8 6 5 12
    WORDS 9 15 5 11 6 8 13 12
    WORDS 5 12 13 14 11 8 5 6
rmd_sr:
    WORDS 8 9 9 11 13 15 15 5
    WORDS 7 7 8 11 14 14 12 6
    WORDS 9 13 15 7 12 8 9 11
    WORDS 7 7 12 7 6 15 13 11
    WORDS 9 7 15 11 8 6 6 14
    WORDS 12 13 5 14 13 13 7 5
    WORDS 15 5 8 11 14 14 6 14
    WORDS 6 9 12 9 12 5 15 8
    WORDS 8 5 12 9 12 5 14 6
    WORDS 8 13 6 5 15 13 11 11
rmd_kl:
    WORDS 0x00000000 0x5a827999 0x6ed9eba1 0x8f1bbcdc 0xa953fd4e
rmd_kr:
    WORDS 0x50a28be6 0x5c4dd124 0x6d703ef3 0x7a6d76e9 0x00000000
