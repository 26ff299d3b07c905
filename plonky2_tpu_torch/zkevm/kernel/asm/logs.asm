// Event logs + the 2048-bit receipt bloom (twin of reference
// cpu/kernel/asm/core/log.asm LOG0..LOG4 and the logs-bloom of
// mpt/hash receipt encoding, re-targeted at the word machine).
//
// Log records live contiguously in (0, SEG_LOGS), bump-allocated via
// @GLOBAL_LOG_ALLOC with @GLOBAL_LOG_COUNT records of layout
//   [logger_addr, ntopics, topic_0 .., data_len, data_byte_0 ..]
// (one byte per data cell).  sys_log journals the PREVIOUS
// (count, alloc) pair under @J_LOG before appending, so a frame revert
// truncates its logs exactly (the reference journals one entry per log
// the same way, journal/log.asm); by receipt-build time the list holds
// precisely the surviving logs, newest last, in emission order.
//
// Stack comments list the TOP first.

%macro logs_read
    PUSH @SEGMENT_LOGS
    MLOAD_GENERAL
%endmacro

%macro logs_write
    PUSH @SEGMENT_LOGS
    MSTORE_GENERAL
%endmacro

// sys_log: LOG0..LOG4 (0xa0+n).  stack: trap, offset, size, topic..
// Gas (EVM exact): 375 + 375*n + 8*size.
global sys_log:
    %assert_not_static
    // memory window [offset, offset+size)
    DUP3
    DUP3
    ADD                          // [end, trap, offset, size, t..]
    %charge_memory
    DUP1
    %opcode_from_syscall_trap       // [opcode, trap, offset, size, t..]
    PUSH 0xa0
    SWAP1
    SUB                          // [n, trap, offset, size, t..]
    %mload_global(@GLOBAL_LOG_COUNT)
    %mload_global(@GLOBAL_LOG_ALLOC)
    %stack (alloc, count, n) -> (@J_LOG, count, alloc, 0, sl_1, n)
    %jump(journal_append)
sl_1:
    // stack: n, trap, offset, size, t..
    %mload_global(@GLOBAL_LOG_ALLOC)
    %push_ctx_meta(@CTX_ADDRESS) // [logger, p, n, trap, offset, size, t..]
    DUP2
    %logs_write                  // LOGS[p] = logger
    DUP2
    DUP2
    PUSH 1
    ADD
    %logs_write                  // LOGS[p+1] = n ; [p, n, trap, ...]
    PUSH 2
    ADD                          // [q = p+2, n, trap, offset, size, t..]
    SWAP1                        // [n, q, trap, offset, size, t..]
sl_topics:
    DUP1
    ISZERO
    %jumpi(sl_topics_done)
    %stack (n, q, trap, offset, size, t) -> (q, t, n, q, trap, offset, size)
    %logs_write                  // LOGS[q] = t
    %stack (n, q) -> (n, 1, q, 1)
    SUB                          // [n-1, q, 1, trap, ...]
    %stack (n, q, one) -> (q, one, n)
    ADD                          // [q+1, n, trap, ...]
    SWAP1
    %jump(sl_topics)
sl_topics_done:
    // stack: 0, q, trap, offset, size
    POP                          // [q, trap, offset, size]
    DUP4
    DUP2
    %logs_write                  // LOGS[q] = size ; [q, trap, offset, size]
    PUSH 1
    ADD                          // [q+1, trap, offset, size]
    // data bytes: frame BYTES[offset+i] -> LOGS[q+i]
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, q, trap, offset, size]
    PUSH 0                       // [i, bsw, q, trap, offset, size]
sl_data:
    DUP6
    DUP2
    EQ
    %jumpi(sl_data_done)
    %stack (i, bsw, q, trap, offset) -> (offset, i, bsw, i, bsw, q, trap, offset)
    ADD                          // [offset+i, bsw, i, ...]
    SWAP1                        // [bsw, offset+i, i, bsw, q, trap, offset, size]
    MLOAD_GENERAL                // [b, i, bsw, q, trap, offset, size]
    %stack (b, i, bsw, q) -> (q, i, b, i, bsw, q)
    ADD                          // [q+i, b, i, bsw, q, ...]
    %logs_write                  // [i, bsw, q, trap, offset, size]
    PUSH 1
    ADD
    %jump(sl_data)
sl_data_done:
    // stack: i, bsw, q, trap, offset, size
    %stack (i, bsw, q, trap, offset, size) -> (q, size, size, trap)
    ADD
    %mstore_global(@GLOBAL_LOG_ALLOC)
    %mload_global(@GLOBAL_LOG_COUNT)
    PUSH 1
    ADD
    %mstore_global(@GLOBAL_LOG_COUNT)
    // stack: size, trap — dynamic gas 375 + 375*n + 8*size
    DUP2
    %opcode_from_syscall_trap
    PUSH 0xa0
    SWAP1
    SUB                          // [n, size, trap]
    PUSH 375
    MUL
    PUSH 375
    ADD                          // [375 + 375n, size, trap]
    SWAP1
    PUSH 8
    MUL                          // [8*size, 375+375n, trap]
    ADD                          // [gas, trap]
    PUSH 192
    SHL
    ADD                          // [trap'] — trap += gas<<192
    EXIT_KERNEL

// ------------------------------------------------------ receipt bloom

// build_log_bloom(retdest) -> baddr: a fresh 256-byte RLP-scratch
// buffer holding the bloom of every surviving log's address + topics
// (EVM: 3 bits per value, from the keccak digest's byte pairs
// (0,1),(2,3),(4,5), each taken mod 2048).
global build_log_bloom:
    PUSH 256
    %rlp_alloc                   // [baddr, retdest] — fresh zero bytes
    %mload_global(@GLOBAL_LOG_COUNT)
    PUSH 0                       // [p, count, baddr, retdest]
blb_logs:
    DUP2
    ISZERO
    %jumpi(blb_done)
    DUP1
    %logs_read                   // [logger, p, count, baddr, retdest]
    DUP4
    %stack (baddr, logger) -> (logger, 20, baddr, blb_1)
    %jump(bloom_accum)
blb_1:
    // stack: p, count, baddr, retdest
    DUP1
    PUSH 1
    ADD
    %logs_read                   // [n, p, count, baddr, retdest]
    PUSH 0                       // [j, n, p, count, baddr, retdest]
blb_topics:
    DUP2
    DUP2
    EQ
    %jumpi(blb_topics_done)
    %stack (j, n, p) -> (p, 2, j, j, n, p)
    ADD
    ADD                          // [p+2+j, j, n, p, count, baddr, retdest]
    %logs_read                   // [topic, j, n, p, count, baddr, retdest]
    DUP6
    %stack (baddr, topic) -> (topic, 32, baddr, blb_2)
    %jump(bloom_accum)
blb_2:
    // stack: j, n, p, count, baddr, retdest
    PUSH 1
    ADD
    %jump(blb_topics)
blb_topics_done:
    // stack: j, n, p, count, baddr, retdest — p += 3 + n + dlen
    POP                          // [n, p, count, baddr, retdest]
    %stack (n, p) -> (p, 2, n, n, p)
    ADD
    ADD                          // [p+2+n, n, p, count, baddr, retdest]
    %logs_read                   // [dlen, n, p, count, baddr, retdest]
    %stack (dlen, n, p) -> (p, 3, n, dlen)
    ADD
    ADD
    ADD                          // [p', count, baddr, retdest]
    SWAP1
    PUSH 1
    SWAP1
    SUB                          // [count-1, p', baddr, retdest]
    SWAP1
    %jump(blb_logs)
blb_done:
    %stack (p, count, baddr, retdest) -> (retdest, baddr)
    JUMP

// bloom_accum(value, nbytes, baddr, retdest): OR the three bloom bits
// of keccak(value as nbytes big-endian bytes) into RLP[baddr..+256).
global bloom_accum:
    // stack: value, nbytes, baddr, retdest
    DUP2
    %rlp_alloc                   // [scratch, value, nbytes, baddr, retdest]
    %stack (scratch, value, nbytes) -> (scratch, value, nbytes, ba_0, scratch, nbytes)
    %jump(mstore_be)
ba_0:
    // stack: scratch, nbytes, baddr, retdest
    %stack (scratch, nbytes) -> (@SEGMENT_RLP, scratch, nbytes)
    KECCAK_GENERAL               // [digest_le, baddr, retdest]
    %stack (d) -> (d, ba_1)
    %jump(byteswap32)
ba_1:
    // stack: digest, baddr, retdest — pairs (0,1),(2,3),(4,5) from the top
    DUP1
    PUSH 240
    SHR                          // [pair01, digest, baddr, retdest]
    DUP3
    %stack (baddr, pair) -> (pair, baddr, ba_2)
    %jump(bloom_bit)
ba_2:
    DUP1
    PUSH 224
    SHR
    PUSH 0xffff
    AND
    DUP3
    %stack (baddr, pair) -> (pair, baddr, ba_3)
    %jump(bloom_bit)
ba_3:
    DUP1
    PUSH 208
    SHR
    PUSH 0xffff
    AND
    DUP3
    %stack (baddr, pair) -> (pair, baddr, ba_4)
    %jump(bloom_bit)
ba_4:
    // stack: digest, baddr, retdest
    POP
    POP
    JUMP

// bloom_bit(pair, baddr, retdest): m = pair & 0x7ff;
// RLP[baddr + 255 - m/8] |= 1 << (m % 8)
global bloom_bit:
    PUSH 0x7ff
    AND                          // [m, baddr, retdest]
    DUP1
    PUSH 3
    SHR                          // [m>>3, m, baddr, retdest]
    PUSH 255
    SUB                          // [255 - (m>>3), m, baddr, retdest]
    DUP3
    ADD                          // [addr, m, baddr, retdest]
    SWAP1                        // [m, addr, baddr, retdest]
    PUSH 7
    AND                          // [m&7, addr, baddr, retdest]
    PUSH 1
    SWAP1
    SHL                          // [1 << (m&7), addr, baddr, retdest]
    DUP2
    %rlp_read                    // [old, mask, addr, baddr, retdest]
    OR
    SWAP1                        // [addr, new, baddr, retdest]
    %rlp_write                   // [baddr, retdest]
    POP
    JUMP

// ---------------------------------------------------- logs RLP encoding

// encode_log_entry(p, retdest) -> (addr, len, p_next): one log record
// at LOGS[p] as rlp([address, [topics..], data]).
global encode_log_entry:
    // stack: p, retdest
    PUSH 6
    %trie_alloc                  // [sc, p, retdest] — 3 (addr,len) pairs
    // item 0: the 20-byte address string (0x94 + bytes)
    PUSH 21
    %rlp_alloc                   // [a, sc, p, retdest]
    DUP1
    PUSH 0x94
    SWAP1
    %rlp_write                   // RLP[a] = 0x94
    DUP3
    %logs_read                   // [logger, a, sc, p, retdest]
    DUP2
    PUSH 1
    ADD                          // [a+1, logger, a, sc, p, retdest]
    %stack (a1, logger) -> (a1, logger, 20, ele_1)
    %jump(mstore_be)
ele_1:
    // stack: a, sc, p, retdest — pair 0 = (a, 21)
    DUP2
    %trie_write                  // TRIE[sc] = a ; [sc, p, retdest]
    DUP1
    PUSH 1
    ADD
    PUSH 21
    SWAP1
    %trie_write                  // TRIE[sc+1] = 21 ; [sc, p, retdest]
    // item 1: the topics list — header then n contiguous 33-byte items
    // (the bump allocator makes the post-header payload allocation
    // land immediately after the header bytes)
    DUP2
    PUSH 1
    ADD
    %logs_read                   // [n, sc, p, retdest]
    DUP1
    PUSH 33
    MUL                          // [pl = 33n, n, sc, p, retdest]
    %stack (pl, n) -> (pl, ele_2, n, pl)
    %jump(rlp_list_header)
ele_2:
    // stack: haddr, hlen, n, pl, sc, p, retdest
    DUP4
    %rlp_alloc                   // [pa, haddr, hlen, n, pl, sc, p, retdest]
    PUSH 0                       // [j, pa, ...]
ele_t_loop:
    DUP5
    DUP2
    EQ
    %jumpi(ele_t_done)
    DUP8                         // [p, j, pa, haddr, hlen, n, pl, sc, p, retdest]
    DUP2
    ADD
    PUSH 2
    ADD                          // [p+2+j, j, pa, ...]
    %logs_read                   // [t, j, pa, haddr, hlen, n, pl, sc, p, retdest]
    DUP2
    PUSH 33
    MUL
    DUP4
    ADD                          // [cell = pa+33j, t, j, pa, ...]
    DUP1
    PUSH 0xa0
    SWAP1
    %rlp_write                   // RLP[cell] = 0xa0
    PUSH 1
    ADD                          // [cell+1, t, j, pa, ...]
    %stack (c1, t) -> (c1, t, 32, ele_t_next)
    %jump(mstore_be)
ele_t_next:
    // stack: j, pa, haddr, hlen, n, pl, sc, p, retdest
    PUSH 1
    ADD
    %jump(ele_t_loop)
ele_t_done:
    // stack: j, pa, haddr, hlen, n, pl, sc, p, retdest
    // pair 1 = (haddr, hlen + 33n)
    %stack (j, pa, haddr, hlen, n, pl, sc) -> (hlen, pl, haddr, n, sc)
    ADD                          // [len1, haddr, n, sc, p, retdest]
    SWAP1                        // [haddr, len1, n, sc, p, retdest]
    DUP4
    PUSH 2
    ADD
    %trie_write                  // TRIE[sc+2] = haddr ; [len1, n, sc, p, retdest]
    DUP3
    PUSH 3
    ADD
    %trie_write                  // TRIE[sc+3] = len1 ; [n, sc, p, retdest]
    // item 2: the data string — copy bytes to RLP scratch, wrap
    DUP3
    DUP2
    ADD
    PUSH 2
    ADD                          // [pd = p+2+n, n, sc, p, retdest]
    DUP1
    %logs_read                   // [dlen, pd, n, sc, p, retdest]
    SWAP1
    PUSH 1
    ADD                          // [db = pd+1, dlen, n, sc, p, retdest]
    DUP2
    %rlp_alloc                   // [da, db, dlen, n, sc, p, retdest]
    PUSH 0                       // [i, da, db, dlen, n, sc, p, retdest]
ele_d_loop:
    DUP4
    DUP2
    EQ
    %jumpi(ele_d_done)
    %stack (i, da, db) -> (db, i, i, da, db)
    ADD                          // [db+i, i, da, db, dlen, ...]
    %logs_read                   // [b, i, da, db, dlen, ...]
    DUP2
    DUP4
    ADD                          // [da+i, b, i, da, db, ...]
    %rlp_write                   // [i, da, db, dlen, n, sc, p, retdest]
    PUSH 1
    ADD
    %jump(ele_d_loop)
ele_d_done:
    // stack: i, da, db, dlen, n, sc, p, retdest
    %stack (i, da, db, dlen) -> (da, dlen, ele_3, dlen)
    %jump(rlp_wrap_string)
ele_3:
    // stack: ad, ld, dlen, n, sc, p, retdest — pair 2 = (ad, ld)
    DUP5
    PUSH 4
    ADD
    %trie_write                  // TRIE[sc+4] = ad ; [ld, dlen, n, sc, p, retdest]
    DUP4
    PUSH 5
    ADD
    %trie_write                  // TRIE[sc+5] = ld ; [dlen, n, sc, p, retdest]
    // p_next = p + 3 + n + dlen
    %stack (dlen, n, sc, p) -> (p, 3, n, dlen, sc)
    ADD
    ADD
    ADD                          // [p_next, sc, retdest]
    SWAP1                        // [sc, p_next, retdest]
    %stack (sc) -> (sc, 3, ele_4)
    %jump(cat_items)
ele_4:
    // stack: addr, len, p_next, retdest
    %stack (addr, len, pn, retdest) -> (retdest, addr, len, pn)
    JUMP

// encode_logs_rlp(retdest) -> (addr, len): the receipt's logs list.
global encode_logs_rlp:
    %mload_global(@GLOBAL_LOG_COUNT)
    DUP1
    DUP1
    ADD
    %trie_alloc                  // [scratch, count, retdest]
    %stack (scratch, count) -> (0, 0, scratch, count)
    // stack: k, p, scratch, count, retdest
elr_loop:
    DUP4
    DUP2
    EQ
    %jumpi(elr_done)
    DUP2
    %stack (p) -> (p, elr_1)
    %jump(encode_log_entry)
elr_1:
    // stack: addr, len, p_next, k, p, scratch, count, retdest
    %stack (addr, len, pn, k, p, scratch) -> (k, k, scratch, addr, len, pn, k, scratch)
    ADD
    ADD                          // [scratch+2k, addr, ...]
    %trie_write                  // [len, pn, k, scratch, count, retdest]
    %stack (len, pn, k, scratch) -> (k, k, scratch, 1, len, pn, k, scratch)
    ADD
    ADD
    ADD                          // [scratch+2k+1, len, ...]
    %trie_write                  // [pn, k, scratch, count, retdest]
    SWAP1
    PUSH 1
    ADD                          // [k+1, pn, scratch, count, retdest]
    %jump(elr_loop)
elr_done:
    // stack: k, p, scratch, count, retdest
    %stack (k, p, scratch, count) -> (scratch, count, elr_2)
    %jump(cat_items)
elr_2:
    // stack: addr, len, retdest
    %stack (addr, len, retdest) -> (retdest, addr, len)
    JUMP
