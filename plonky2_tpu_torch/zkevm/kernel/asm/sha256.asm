// SHA-256 + the 0x02 precompile (twin of reference
// cpu/kernel/asm/hash/sha2/{main.asm,compression.asm,
// message_schedule.asm} + core/precompiles/sha256.asm, re-targeted at
// the word machine: 32-bit lane arithmetic on the 256-bit ALU with
// explicit masking).
//
// The 64 K round constants live as a WORDS block (immediate words of
// the kernel image, read back through SEG_CODE at 2*(sha_k + i) + 1).
// Per-call state uses fresh TRIE cells at @GLOBAL_SHA_BASE:
//   +0..7   running H0..H7
//   +8..71  message schedule W[0..63]
//   +72 padded length  +73 input offset  +74 input segword
//   +75 input byte length  +80..87 working a..h
// Stack comments list the TOP first.

%macro sha_load(slot)
    %mload_global(@GLOBAL_SHA_BASE)
    PUSH $slot
    ADD
    %trie_read
%endmacro

%macro sha_store(slot)           // [value, ..] -> [..]
    %mload_global(@GLOBAL_SHA_BASE)
    PUSH $slot
    ADD
    %trie_write
%endmacro

%macro sha_w_read                // [t, ..] -> [W[t], ..]
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    PUSH 8
    ADD
    %trie_read
%endmacro

%macro sha_w_write               // [t, v, ..] -> [..]
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    PUSH 8
    ADD
    %trie_write
%endmacro

%macro rotr32                    // [x, n, ..] -> [rotr32(x, n), ..]
    DUP2
    DUP2
    SWAP1                        // [n, x, x, n]
    SHR                          // [x >> n, x, n]
    %stack (lo, x, n) -> (32, n, x, lo)
    SUB                          // [32-n, x, lo]
    SHL                          // [x << (32-n), lo]
    OR
    PUSH 0xffffffff
    AND
%endmacro

%macro add32                     // [a, b, ..] -> [(a+b) & 2^32-1, ..]
    ADD
    PUSH 0xffffffff
    AND
%endmacro

// sha_pad_byte(i, retdest) -> b: byte i of the SHA-padded message.
global sha_pad_byte:
    // stack: i, retdest
    %sha_load(75)
    DUP2
    LT                           // [i < nbytes, i, retdest]
    %jumpi(spb_data)
    DUP1
    %sha_load(75)
    EQ
    %jumpi(spb_80)
    %sha_load(72)
    PUSH 8
    SWAP1
    SUB                          // [plen-8, i, retdest]
    DUP2
    LT                           // [i < plen-8, i, retdest]
    %jumpi(spb_zero)
    // length tail: k = i - (plen-8); byte = bitlen >> 8*(7-k)
    %sha_load(72)
    PUSH 8
    SWAP1
    SUB
    SWAP1
    SUB                          // [k, retdest]
    PUSH 7
    SUB                          // [7-k, retdest]
    PUSH 3
    SHL                          // [8*(7-k), retdest]
    %sha_load(75)
    PUSH 3
    SHL                          // [bitlen, shift, retdest]
    SWAP1
    SHR                          // [bitlen >> shift, retdest]
    PUSH 0xff
    AND
    SWAP1
    JUMP
spb_data:
    // stack: i, retdest
    %sha_load(73)
    ADD                          // [offset+i, retdest]
    %sha_load(74)                // [bsw, addr, retdest]
    MLOAD_GENERAL                // [b, retdest]
    SWAP1
    JUMP
spb_80:
    %stack (i, retdest) -> (retdest, 0x80)
    JUMP
spb_zero:
    %stack (i, retdest) -> (retdest, 0)
    JUMP

// sha256(bsw, offset, nbytes, retdest) -> digest (one 256-bit word)
global sha256:
    // stack: bsw, offset, nbytes, retdest
    PUSH 88
    %trie_alloc
    %mstore_global(@GLOBAL_SHA_BASE)
    %sha_store(74)               // [offset, nbytes, retdest]
    %sha_store(73)               // [nbytes, retdest]
    DUP1
    %sha_store(75)
    PUSH 0x6a09e667
    %sha_store(0)
    PUSH 0xbb67ae85
    %sha_store(1)
    PUSH 0x3c6ef372
    %sha_store(2)
    PUSH 0xa54ff53a
    %sha_store(3)
    PUSH 0x510e527f
    %sha_store(4)
    PUSH 0x9b05688c
    %sha_store(5)
    PUSH 0x1f83d9ab
    %sha_store(6)
    PUSH 0x5be0cd19
    %sha_store(7)
    // padded length = ((nbytes + 8) >> 6 + 1) << 6
    PUSH 8
    ADD
    PUSH 6
    SHR
    PUSH 1
    ADD
    PUSH 6
    SHL
    %sha_store(72)               // [retdest]
    PUSH 0                       // [blk, retdest]
sha_blocks:
    %sha_load(72)
    DUP2
    EQ
    %jumpi(sha_out)
    // ---- W[0..15]: 4 padded bytes each, big-endian
    PUSH 0                       // [t, blk, retdest]
sw16:
    DUP1
    PUSH 16
    EQ
    %jumpi(sw16_done)
    PUSH 0
    PUSH 0                       // [j, acc, t, blk, retdest]
swb:
    DUP1
    PUSH 4
    EQ
    %jumpi(swb_done)
    %stack (j, acc, t, blk) -> (4, t, blk, j, j, acc, t, blk)
    MUL
    ADD
    ADD                          // [i = 4t+blk+j, j, acc, t, blk, retdest]
    %stack (i) -> (i, swb_1)
    %jump(sha_pad_byte)
swb_1:
    // stack: b, j, acc, t, blk, retdest
    %stack (b, j, acc) -> (8, acc, b, j)
    SHL                          // [acc<<8, b, j, t, blk, retdest]
    OR                           // [acc', j, t, blk, retdest]
    SWAP1
    PUSH 1
    ADD                          // [j+1, acc', t, blk, retdest]
    %jump(swb)
swb_done:
    // stack: 4, acc, t, blk, retdest
    POP
    DUP2
    %sha_w_write                 // W[t] = acc ; [t, blk, retdest]
    PUSH 1
    ADD
    %jump(sw16)
sw16_done:
    // ---- W[16..63]
sw48:
    DUP1
    PUSH 64
    EQ
    %jumpi(sw48_done)
    // s0 = rotr(w15,7) ^ rotr(w15,18) ^ (w15 >> 3)
    DUP1
    PUSH 15
    SWAP1
    SUB
    %sha_w_read                  // [w15, t, blk, retdest]
    PUSH 7
    DUP2
    %rotr32                      // [r7, w15, t, blk, retdest]
    PUSH 18
    DUP3
    %rotr32
    XOR                          // [r7^r18, w15, t, blk, retdest]
    SWAP1
    PUSH 3
    SHR                          // [w15>>3, x, t, blk, retdest]
    XOR                          // [s0, t, blk, retdest]
    DUP2
    PUSH 16
    SWAP1
    SUB
    %sha_w_read
    %add32                       // [s0+w16, t, blk, retdest]
    DUP2
    PUSH 7
    SWAP1
    SUB
    %sha_w_read
    %add32                       // [sum, t, blk, retdest]
    // s1 = rotr(w2,17) ^ rotr(w2,19) ^ (w2 >> 10)
    DUP2
    PUSH 2
    SWAP1
    SUB
    %sha_w_read                  // [w2, sum, t, blk, retdest]
    PUSH 17
    DUP2
    %rotr32
    PUSH 19
    DUP3
    %rotr32
    XOR                          // [x, w2, sum, t, blk, retdest]
    SWAP1
    PUSH 10
    SHR                          // [w2>>10, x, sum, t, blk, retdest]
    XOR                          // [s1, sum, t, blk, retdest]
    %add32                       // [W_t, t, blk, retdest]
    DUP2
    %sha_w_write                 // [t, blk, retdest]
    PUSH 1
    ADD
    %jump(sw48)
sw48_done:
    POP                          // [blk, retdest]
    // ---- working vars = H
    PUSH 0
scp:
    DUP1
    PUSH 8
    EQ
    %jumpi(scp_done)
    DUP1
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    %trie_read                   // [H_i, i, blk, retdest]
    DUP2
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    PUSH 80
    ADD
    %trie_write                  // [i, blk, retdest]
    PUSH 1
    ADD
    %jump(scp)
scp_done:
    POP
    // ---- 64 rounds (a..h in cells 80..87)
    PUSH 0                       // [t, blk, retdest]
srnd:
    DUP1
    PUSH 64
    EQ
    %jumpi(srnd_done)
    %sha_load(84)                // [e, t, blk, retdest]
    PUSH 6
    DUP2
    %rotr32
    PUSH 11
    DUP3
    %rotr32
    XOR
    PUSH 25
    DUP3
    %rotr32
    XOR                          // [S1, e, t, blk, retdest]
    DUP2
    %sha_load(85)
    AND                          // [e&f, S1, e, t, blk, retdest]
    DUP3
    NOT
    PUSH 0xffffffff
    AND
    %sha_load(86)
    AND                          // [~e&g, e&f, S1, e, t, blk, retdest]
    XOR                          // [ch, S1, e, t, blk, retdest]
    %sha_load(87)
    %add32                       // [h+ch, S1, e, t, blk, retdest]
    %add32                       // [x, e, t, blk, retdest]
    DUP3
    %sha_kconst
    %add32                       // [x', e, t, blk, retdest]
    DUP3
    %sha_w_read
    %add32                       // [t1, e, t, blk, retdest]
    SWAP1
    POP                          // [t1, t, blk, retdest]
    %sha_load(80)                // [a, t1, t, blk, retdest]
    PUSH 2
    DUP2
    %rotr32
    PUSH 13
    DUP3
    %rotr32
    XOR
    PUSH 22
    DUP3
    %rotr32
    XOR                          // [S0, a, t1, t, blk, retdest]
    SWAP1
    POP                          // [S0, t1, t, blk, retdest]
    %sha_load(80)
    %sha_load(81)
    AND
    %sha_load(80)
    %sha_load(82)
    AND
    XOR
    %sha_load(81)
    %sha_load(82)
    AND
    XOR                          // [maj, S0, t1, t, blk, retdest]
    %add32                       // [t2, t1, t, blk, retdest]
    %sha_load(86)
    %sha_store(87)               // h = g
    %sha_load(85)
    %sha_store(86)               // g = f
    %sha_load(84)
    %sha_store(85)               // f = e
    %sha_load(83)
    DUP3
    %add32
    %sha_store(84)               // e = d + t1
    %sha_load(82)
    %sha_store(83)               // d = c
    %sha_load(81)
    %sha_store(82)               // c = b
    %sha_load(80)
    %sha_store(81)               // b = a
    %add32
    %sha_store(80)               // a = t1 + t2 ; [t, blk, retdest]
    PUSH 1
    ADD
    %jump(srnd)
srnd_done:
    POP                          // [blk, retdest]
    // ---- H += working
    PUSH 0
shh:
    DUP1
    PUSH 8
    EQ
    %jumpi(shh_done)
    DUP1
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    PUSH 80
    ADD
    %trie_read                   // [w_i, i, blk, retdest]
    DUP2
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    %trie_read                   // [H_i, w_i, i, blk, retdest]
    %add32                       // [H', i, blk, retdest]
    DUP2
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    %trie_write                  // [i, blk, retdest]
    PUSH 1
    ADD
    %jump(shh)
shh_done:
    POP
    PUSH 64
    ADD                          // [blk+64, retdest]
    %jump(sha_blocks)
sha_out:
    POP                          // [retdest]
    PUSH 0
    PUSH 0                       // [i, acc, retdest]
sdg:
    DUP1
    PUSH 8
    EQ
    %jumpi(sdg_done)
    %stack (i, acc) -> (32, acc, i)
    SHL                          // [acc<<32, i, retdest]
    DUP2
    %mload_global(@GLOBAL_SHA_BASE)
    ADD
    %trie_read                   // [H_i, acc', i, retdest]
    OR                           // [acc'', i, retdest]
    SWAP1
    PUSH 1
    ADD                          // [i+1, acc'', retdest]
    %jump(sdg)
sdg_done:
    %stack (i, acc, retdest) -> (retdest, acc)
    JUMP

// ---- 0x02 precompile: digest of BYTES[ao .. ao+asz)
global pc_sha256:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, trap, value, ao, asz, ro, rs]
    %stack (bsw, trap, value, ao, asz) -> (bsw, ao, asz, psh_1, trap, value, ao, asz)
    %jump(sha256)
psh_1:
    // stack: digest, trap, value, ao, asz, ro, rs
    %stack (d) -> (@SEGMENT_RETURNDATA, 0, d, 32, psh_2)
    %jump(mstore_be_gen)
psh_2:
    PUSH 32
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %jump(pc_done)

// [i, ..] -> [K_i, ..]: the round constant from the WORDS block below
%macro sha_kconst
    PUSH sha_k
    ADD
    DUP1
    ADD
    PUSH 1
    ADD
    PUSH @SEGMENT_CODE
    MLOAD_GENERAL
%endmacro

sha_k:
    WORDS 0x428a2f98 0x71374491 0xb5c0fbcf 0xe9b5dba5 0x3956c25b 0x59f111f1 0x923f82a4 0xab1c5ed5
    WORDS 0xd807aa98 0x12835b01 0x243185be 0x550c7dc3 0x72be5d74 0x80deb1fe 0x9bdc06a7 0xc19bf174
    WORDS 0xe49b69c1 0xefbe4786 0x0fc19dc6 0x240ca1cc 0x2de92c6f 0x4a7484aa 0x5cb0a9dc 0x76f988da
    WORDS 0x983e5152 0xa831c66d 0xb00327c8 0xbf597fc7 0xc6e00bf3 0xd5a79147 0x06ca6351 0x14292967
    WORDS 0x27b70a85 0x2e1b2138 0x4d2c6dfc 0x53380d13 0x650a7354 0x766a0abb 0x81c2c92e 0x92722c85
    WORDS 0xa2bfe8a1 0xa81a664b 0xc24b8b70 0xc76c51a3 0xd192e819 0xd6990624 0xf40e3585 0x106aa070
    WORDS 0x19a4c116 0x1e376c08 0x2748774c 0x34b0bcb5 0x391c0cb3 0x4ed8aa4a 0x5b9cca4f 0x682e6ff3
    WORDS 0x748f82ee 0x78a5636f 0x84c87814 0x8cc70208 0x90befffa 0xa4506ceb 0xbef9a3f7 0xc67178f2
