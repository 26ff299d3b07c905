// Memory helper macros + byte-buffer routines (twin of reference
// cpu/kernel/asm/memory/{core.asm,memcpy.asm,packing.asm}, re-targeted
// at the word machine's (segment, virt) addressing).
//
// Stack comments list the TOP first. Calling convention: caller pushes
// retdest, then arguments above it; routines exit by jumping to
// retdest with their results on top (reference kernel convention).
// EVM operand order: SUB/SHR/SHL/DIV/MOD take the TOP as a/dividend/
// displacement.

// [addr, value, ..] -> [..] : TRIE[addr] = value
%macro trie_write
    PUSH @SEGMENT_TRIE
    MSTORE_GENERAL
%endmacro

// [addr, ..] -> [value, ..]
%macro trie_read
    PUSH @SEGMENT_TRIE
    MLOAD_GENERAL
%endmacro

// [addr, value, ..] -> [..] : RLP[addr] = value (one byte)
%macro rlp_write
    PUSH @SEGMENT_RLP
    MSTORE_GENERAL
%endmacro

// [addr, ..] -> [value, ..]
%macro rlp_read
    PUSH @SEGMENT_RLP
    MLOAD_GENERAL
%endmacro

// [n, ..] -> [ptr, ..] : bump-allocate n trie-data cells
%macro trie_alloc
    %mload_global(@GLOBAL_TRIE_ALLOC)
    %stack (cur, n) -> (cur, n, cur)
    ADD
    %mstore_global(@GLOBAL_TRIE_ALLOC)
%endmacro

// [n, ..] -> [addr, ..] : bump-allocate n bytes of RLP scratch
%macro rlp_alloc
    %mload_global(@GLOBAL_RLP_ALLOC)
    %stack (cur, n) -> (cur, n, cur)
    ADD
    %mstore_global(@GLOBAL_RLP_ALLOC)
%endmacro

// [v, ..] -> [len, ..] : minimal big-endian byte length of v (0 -> 0)
global scalar_byte_len:
    // stack: v, retdest
    PUSH 0
    SWAP1                        // [v, len, retdest]
byte_len_loop:
    // stack: v, len, retdest
    DUP1
    ISZERO
    %jumpi(byte_len_done)
    %stack (v, len) -> (8, v, 1, len)
    SHR                          // [v >> 8, 1, len]
    %stack (v, one, len) -> (one, len, v)
    ADD                          // [len + 1, v]
    SWAP1
    %jump(byte_len_loop)
byte_len_done:
    %stack (v, len, retdest) -> (retdest, len)
    JUMP

// Write the n low bytes of `value` big-endian at RLP[addr..addr+n).
// stack: addr, value, n, retdest -> (empty)
global mstore_be:
mstore_be_loop:
    // stack: addr, value, n, retdest
    DUP3
    ISZERO
    %jumpi(mstore_be_done)
    // byte = (value >> 8*(n-1)) & 0xff
    %stack (addr, value, n) -> (n, 1, 8, value, addr, value, n)
    SUB                          // [n-1, 8, value, addr, value, n]
    MUL                          // [8(n-1), value, addr, value, n]
    SHR                          // [value >> 8(n-1), addr, value, n]
    PUSH 0xff
    AND                          // [byte, addr, value, n]
    DUP2                         // [addr, byte, addr, value, n]
    %rlp_write                   // [addr, value, n, retdest]
    %stack (addr, value, n) -> (1, addr, value, n, 1)
    ADD                          // [addr+1, value, n, 1]
    %stack (addr, value, n, one) -> (n, one, addr, value)
    SUB                          // [n-1, addr, value]
    %stack (n, addr, value) -> (addr, value, n)
    %jump(mstore_be_loop)
mstore_be_done:
    %stack (addr, value, n, retdest) -> (retdest)
    JUMP

// Copy n bytes RLP[src..src+n) -> RLP[dst..dst+n).
// stack: dst, src, n, retdest -> (empty)
global rlp_memcpy:
rlp_memcpy_loop:
    // stack: dst, src, n, retdest
    DUP3
    ISZERO
    %jumpi(rlp_memcpy_done)
    DUP2
    %rlp_read                    // [byte, dst, src, n]
    DUP2                         // [dst, byte, dst, src, n]
    %rlp_write                   // [dst, src, n, retdest]
    %stack (dst, src, n) -> (1, dst, 1, src, n, 1)
    ADD                          // [dst+1, 1, src, n, 1]
    %stack (dst, one, src, n, one2) -> (one, src, dst, n, one2)
    ADD                          // [src+1, dst, n, 1]
    %stack (src, dst, n, one2) -> (n, one2, dst, src)
    SUB                          // [n-1, dst, src]
    %stack (n, dst, src) -> (dst, src, n)
    %jump(rlp_memcpy_loop)
rlp_memcpy_done:
    %stack (dst, src, n, retdest) -> (retdest)
    JUMP

// Write the n low bytes of `value` little-endian at RLP[addr..addr+n)
// (byte j = (value >> 8j) & 0xff — the natural byte order of
// KECCAK_GENERAL's digest word).
// stack: addr, value, n, retdest -> (empty)
global mstore_le:
mstore_le_loop:
    // stack: addr, value, n, retdest
    DUP3
    ISZERO
    %jumpi(mstore_le_done)
    %stack (addr, value, n) -> (value, 0xff, addr, addr, value, n)
    AND                          // [value & 0xff, addr, addr, value, n]
    SWAP1
    %rlp_write                   // [addr, value, n, retdest]
    %stack (addr, value, n) -> (1, addr, 8, value, n, 1)
    ADD                          // [addr+1, 8, value, n, 1]
    %stack (addr, eight, value, n, one) -> (eight, value, addr, n, one)
    SHR                          // [value >> 8, addr, n, 1]
    %stack (value, addr, n, one) -> (n, one, addr, value)
    SUB                          // [n-1, addr, value]
    %stack (n, addr, value) -> (addr, value, n)
    %jump(mstore_le_loop)
mstore_le_done:
    %stack (addr, value, n, retdest) -> (retdest)
    JUMP

// Read n bytes RLP[addr..addr+n) as a big-endian scalar (n <= 32).
// stack: addr, n, retdest -> [value]
global mload_be:
    PUSH 0
    %stack (acc, addr, n) -> (addr, n, acc)
mload_be_loop:
    // stack: addr, n, acc, retdest
    DUP2
    ISZERO
    %jumpi(mload_be_done)
    %stack (addr, n, acc) -> (8, acc, addr, addr, n)
    SHL                          // [acc << 8, addr, addr, n]
    SWAP1
    %rlp_read                    // [byte, acc', addr, n]
    ADD                          // [acc'', addr, n]
    %stack (acc, addr, n) -> (1, addr, n, 1, acc)
    ADD                          // [addr+1, n, 1, acc]
    %stack (addr, n, one, acc) -> (n, one, addr, acc)
    SUB                          // [n-1, addr, acc]
    %stack (n, addr, acc) -> (addr, n, acc)
    %jump(mload_be_loop)
mload_be_done:
    %stack (addr, n, acc, retdest) -> (retdest, acc)
    JUMP

// mload_be_gen(segword, addr, n, retdest) -> word: big-endian read of
// n <= 32 bytes from any byte-granular segment (fresh reads are 0)
global mload_be_gen:
    // stack: segword, addr, n, retdest
    %stack (segword, addr, n) -> (0, n, addr, segword, 0)
    // stack: i, n, addr, segword, acc, retdest
mbg_loop:
    DUP2
    DUP2
    EQ
    %jumpi(mbg_done)
    // byte = seg[addr + i]
    DUP3
    DUP2
    ADD                          // [addr+i, i, n, addr, segword, acc]
    DUP5                         // [segword, addr+i, i, n, addr, segword, acc]
    MLOAD_GENERAL                // [b, i, n, addr, segword, acc]
    DUP6
    PUSH 8
    SHL                          // [acc<<8, b, i, n, addr, segword, acc]
    ADD                          // [acc', i, n, addr, segword, acc]
    SWAP5
    POP                          // [i, n, addr, segword, acc']
    PUSH 1
    ADD
    %jump(mbg_loop)
mbg_done:
    // stack: i, n, addr, segword, acc, retdest
    %stack (i, n, addr, segword, acc, retdest) -> (retdest, acc)
    JUMP

// mstore_be_gen(segword, addr, value, n, retdest): big-endian write of
// the low n <= 32 bytes of value into any byte-granular segment
global mstore_be_gen:
    // stack: segword, addr, value, n, retdest
    SWAP3                        // [n, addr, value, segword, retdest]
msg_loop:
    DUP1
    ISZERO
    %jumpi(msg_done)
    PUSH 1
    SWAP1
    SUB                          // [n-1, addr, value, segword]
    // byte = (value >> 8*(n-1)) & 0xff at seg[addr + n-1... wait
    // big-endian: byte j (0-based from addr) = (value >> 8*(n-1-j));
    // iterate n-1 down to 0 writing seg[addr+k] = (value >> 8*(n-1-k)).
    // Equivalent: this iteration writes k = n-1 with the LOW byte, then
    // shifts value right by 8.
    DUP2
    DUP2
    ADD                          // [addr+(n-1), n-1, addr, value, segword]
    DUP4
    PUSH 0xff
    AND                          // [value&0xff, addr+(n-1), n-1, addr, value, segword]
    SWAP1                        // [addr+(n-1), byte, n-1, addr, value, segword]
    DUP6                         // [segword, addr+(n-1), byte, ...]
    MSTORE_GENERAL               // [n-1, addr, value, segword]
    SWAP2                        // [value, addr, n-1, segword]
    PUSH 8
    SHR                          // [value>>8, addr, n-1, segword]
    SWAP2                        // [n-1, addr, value>>8, segword]
    %jump(msg_loop)
msg_done:
    // stack: n(0), addr, value, segword, retdest
    %stack (n, addr, value, segword, retdest) -> (retdest)
    JUMP
