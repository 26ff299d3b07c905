// RLP item builders over the SEG_RLP byte scratch (twin of reference
// cpu/kernel/asm/rlp/{encode.asm,scalar.asm}, word-machine layout).
// Every builder bump-allocates its output and returns (addr, len):
// the item's bytes live at RLP[addr..addr+len).
//
// Stack comments list the TOP first; routines end by jumping to
// retdest with results on top.

// rlp_scalar(v) -> (addr, len): minimal big-endian integer item
// (0 -> 0x80, v < 0x80 -> itself, else 0x80+blen || bytes).
global rlp_scalar:
    // stack: v, retdest
    DUP1
    PUSH 0x80
    GT                           // 0x80 > v  <=>  v < 0x80
    %jumpi(rlp_scalar_small)
    // multi-byte: blen = scalar_byte_len(v)
    %stack (v) -> (v, rlp_scalar_big, v)
    %jump(scalar_byte_len)
rlp_scalar_big:
    // stack: blen, v, retdest
    DUP1
    PUSH 1
    ADD
    %rlp_alloc                   // [addr, blen, v, retdest]
    // RLP[addr] = 0x80 + blen
    %stack (addr, blen, v) -> (blen, 0x80, addr, addr, blen, v)
    ADD
    DUP2
    %rlp_write                   // [addr, addr, blen, v, retdest]
    // mstore_be(addr+1, v, blen)
    PUSH 1
    ADD                          // [addr+1, addr, blen, v, retdest]
    %stack (addr1, addr, blen, v) -> (addr1, v, blen, rlp_scalar_big_ret, addr, blen)
    %jump(mstore_be)
rlp_scalar_big_ret:
    // stack: addr, blen, retdest
    %stack (addr, blen, retdest) -> (1, blen, retdest, addr)
    ADD                          // [len = blen+1, retdest, addr]
    %stack (len, retdest, addr) -> (retdest, addr, len)
    JUMP

rlp_scalar_small:
    // stack: v, retdest — single byte: 0 encodes as 0x80, else itself
    PUSH 1
    %rlp_alloc                   // [addr, v, retdest]
    DUP2
    ISZERO
    %jumpi(rlp_scalar_zero)
    %stack (addr, v) -> (addr, v, addr)
    %rlp_write                   // [addr, retdest]
rlp_scalar_small_done:
    %stack (addr, retdest) -> (retdest, addr, 1)
    JUMP
rlp_scalar_zero:
    %stack (addr, v) -> (addr, 0x80, addr)
    %rlp_write
    %jump(rlp_scalar_small_done)

// rlp_string_header(payload_len) -> (addr, hlen): the string header
// bytes for a payload of that length (caller prepends; payload_len of
// 1 with a small byte must NOT call this — no header in that case).
global rlp_string_header:
    PUSH 0x80
    PUSH 0xb7
    %jump(rlp_header)

// rlp_list_header(payload_len) -> (addr, hlen)
global rlp_list_header:
    PUSH 0xc0
    PUSH 0xf7
    %jump(rlp_header)

// rlp_header(long_off, short_off, n) -> (addr, hlen)
rlp_header:
    // stack: long_off, short_off, n, retdest
    DUP3
    PUSH 56
    GT                           // 56 > n  <=>  n < 56
    %jumpi(rlp_header_short)
    // long: blen = scalar_byte_len(n); bytes = [long_off+blen, n_be]
    %stack (long_off, short_off, n) -> (n, rlp_header_long, long_off, n)
    %jump(scalar_byte_len)
rlp_header_long:
    // stack: blen, long_off, n, retdest
    DUP1
    PUSH 1
    ADD
    %rlp_alloc                   // [addr, blen, long_off, n, retdest]
    %stack (addr, blen, long_off, n) -> (long_off, blen, addr, addr, n, blen)
    ADD                          // [hdr, addr, addr, n, blen]
    DUP2
    %rlp_write                   // [addr, addr, n, blen, retdest]
    PUSH 1
    ADD                          // [addr+1, addr, n, blen, retdest]
    %stack (addr1, addr, n, blen) -> (addr1, n, blen, rlp_header_long_ret, addr, blen)
    %jump(mstore_be)
rlp_header_long_ret:
    // stack: addr, blen, retdest
    %stack (addr, blen, retdest) -> (blen, 1, retdest, addr)
    ADD                          // [hlen, retdest, addr]
    %stack (hlen, retdest, addr) -> (retdest, addr, hlen)
    JUMP
rlp_header_short:
    // stack: long_off, short_off, n, retdest
    PUSH 1
    %rlp_alloc                   // [addr, long_off, short_off, n, retdest]
    %stack (addr, long_off, short_off, n) -> (short_off, n, addr, addr)
    ADD                          // [hdr, addr, addr, retdest]
    DUP2
    %rlp_write                   // [addr, addr, retdest]
    POP
    %stack (addr, retdest) -> (retdest, addr, 1)
    JUMP

// byteswap32(v) -> v with its 32-byte big-endian representation
// reinterpreted little-endian (digest-word <-> BE-word bridge).
global byteswap32:
    // stack: v, retdest
    PUSH 32
    %rlp_alloc                   // [scratch, v, retdest]
    %stack (scratch, v) -> (scratch, v, 32, byteswap32_ret, scratch)
    %jump(mstore_be)
byteswap32_ret:
    // stack: scratch, retdest — read back little-endian
    PUSH 0
    %stack (acc, scratch) -> (scratch, 31, acc)
    ADD                          // [scratch+31, acc]  (read MSB-last first)
    PUSH 32                      // [n, addr, acc]
    SWAP1                        // [addr, n, acc]
byteswap32_loop:
    // stack: addr, n, acc, retdest
    DUP2
    ISZERO
    %jumpi(byteswap32_done)
    %stack (addr, n, acc) -> (8, acc, addr, addr, n)
    SHL                          // [acc<<8, addr, addr, n]
    SWAP1
    %rlp_read                    // [byte, acc', addr, n]
    ADD                          // [acc'', addr, n]
    %stack (acc, addr, n) -> (addr, 1, n, 1, acc)
    SUB                          // [addr-1, n, 1, acc]
    %stack (addr, n, one, acc) -> (n, one, addr, acc)
    SUB                          // [n-1, addr, acc]
    %stack (n, addr, acc) -> (addr, n, acc)
    %jump(byteswap32_loop)
byteswap32_done:
    %stack (addr, n, acc, retdest) -> (retdest, acc)
    JUMP
