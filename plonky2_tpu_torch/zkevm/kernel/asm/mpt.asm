// MPT kernel routines: load tries from prover inputs, hash tries
// in-machine (twin of reference cpu/kernel/asm/mpt/{load.asm,hash.asm},
// re-targeted at the word machine; node layout follows
// evm/src/generation/trie_extractor.rs:60 read_trie_helper).
//
// SEG_TRIE node cells:
//   EMPTY:     [0]
//   HASH:      [1, digest_be]
//   BRANCH:    [2, c0..c15, value_ptr]        (value_ptr 0 = none)
//   EXTENSION: [3, count, packed, child_ptr]
//   LEAF:      [4, count, packed, value_ptr]
// Values: account [nonce, balance, storage_ptr, code_hash_be];
// storage [word]; bytes [len, b0..b{len-1}].
//
// Function pointers (parser / encoder labels) are pushed and reached
// by computed JUMP — unrestricted in kernel mode (cpu/jumps.rs).
// Stack comments list the TOP first.

// ------------------------------------------------------------- loading

// mpt_load_node(parser, retdest) -> ptr
// parser(retdest) -> value_ptr consumes the value's PROVER_INPUTs.
global mpt_load_node:
    PROVER_INPUT                 // [type, parser, retdest]
    DUP1
    PUSH @MPT_EMPTY
    EQ
    %jumpi(load_empty)
    DUP1
    PUSH @MPT_HASH
    EQ
    %jumpi(load_hash)
    DUP1
    PUSH @MPT_BRANCH
    EQ
    %jumpi(load_branch)
    DUP1
    PUSH @MPT_EXTENSION
    EQ
    %jumpi(load_ext)
    DUP1
    PUSH @MPT_LEAF
    EQ
    %jumpi(load_leaf)
    %jump(panic)

load_empty:
    // stack: type, parser, retdest
    PUSH 1
    %trie_alloc                  // [ptr, type, parser, retdest]
    %stack (ptr, type, parser) -> (ptr, type, ptr)
    %trie_write                  // [ptr, retdest]
    %stack (ptr, retdest) -> (retdest, ptr)
    JUMP

load_hash:
    // stack: type, parser, retdest
    PUSH 2
    %trie_alloc                  // [ptr, type, parser, retdest]
    %stack (ptr, type, parser) -> (ptr, type, ptr)
    %trie_write                  // [ptr, retdest]
    PROVER_INPUT                 // [digest_be, ptr, retdest]
    %stack (digest, ptr) -> (ptr, 1, digest, ptr)
    ADD
    %trie_write                  // [ptr, retdest]
    %stack (ptr, retdest) -> (retdest, ptr)
    JUMP

load_branch:
    // stack: type, parser, retdest
    PUSH 18
    %trie_alloc                  // [ptr, type, parser, retdest]
    %stack (ptr, type, parser) -> (ptr, type, parser, ptr)
    %trie_write                  // [parser, ptr, retdest]
    PROVER_INPUT                 // [value_present, parser, ptr, retdest]
    %jumpi(load_branch_value)
    PUSH 0                       // [value_ptr = 0, parser, ptr, retdest]
load_branch_store_value:
    // stack: vptr, parser, ptr, retdest
    %stack (vptr, parser, ptr) -> (ptr, 17, vptr, parser, ptr)
    ADD
    %trie_write                  // [parser, ptr, retdest]
    PUSH 1                       // child slot i = 1..16
load_branch_child_loop:
    // stack: i, parser, ptr, retdest
    DUP1
    PUSH 17
    EQ
    %jumpi(load_branch_done)
    %stack (i, parser, ptr) -> (parser, load_branch_child_ret, i, parser, ptr)
    %jump(mpt_load_node)
load_branch_child_ret:
    // stack: child, i, parser, ptr, retdest
    %stack (child, i, parser, ptr) -> (ptr, i, child, i, parser, ptr)
    ADD
    %trie_write                  // [i, parser, ptr, retdest]
    PUSH 1
    ADD
    %jump(load_branch_child_loop)
load_branch_done:
    // stack: i, parser, ptr, retdest
    %stack (i, parser, ptr, retdest) -> (retdest, ptr)
    JUMP
load_branch_value:
    // stack: parser, ptr, retdest
    DUP1
    %stack (p1, p2, ptr) -> (p1, load_branch_value_ret, p2, ptr)
    JUMP                         // parser(load_branch_value_ret)
load_branch_value_ret:
    // stack: vptr, parser, ptr, retdest
    %jump(load_branch_store_value)

load_ext:
    // stack: type, parser, retdest
    PUSH 4
    %trie_alloc                  // [ptr, type, parser, retdest]
    %stack (ptr, type, parser) -> (ptr, type, parser, ptr)
    %trie_write                  // [parser, ptr, retdest]
    PROVER_INPUT                 // [count, parser, ptr, retdest]
    %stack (count, parser, ptr) -> (ptr, 1, count, parser, ptr)
    ADD
    %trie_write
    PROVER_INPUT                 // [packed, parser, ptr, retdest]
    %stack (packed, parser, ptr) -> (ptr, 2, packed, parser, ptr)
    ADD
    %trie_write                  // [parser, ptr, retdest]
    %stack (parser, ptr) -> (parser, load_ext_ret, ptr)
    %jump(mpt_load_node)
load_ext_ret:
    // stack: child, ptr, retdest
    %stack (child, ptr) -> (ptr, 3, child, ptr)
    ADD
    %trie_write                  // [ptr, retdest]
    %stack (ptr, retdest) -> (retdest, ptr)
    JUMP

load_leaf:
    // stack: type, parser, retdest
    PUSH 4
    %trie_alloc
    %stack (ptr, type, parser) -> (ptr, type, parser, ptr)
    %trie_write                  // [parser, ptr, retdest]
    PROVER_INPUT
    %stack (count, parser, ptr) -> (ptr, 1, count, parser, ptr)
    ADD
    %trie_write
    PROVER_INPUT
    %stack (packed, parser, ptr) -> (ptr, 2, packed, parser, ptr)
    ADD
    %trie_write                  // [parser, ptr, retdest]
    %stack (parser, ptr) -> (parser, load_leaf_ret, ptr)
    JUMP                         // parser(load_leaf_ret)
load_leaf_ret:
    // stack: vptr, ptr, retdest
    %stack (vptr, ptr) -> (ptr, 3, vptr, ptr)
    ADD
    %trie_write                  // [ptr, retdest]
    %stack (ptr, retdest) -> (retdest, ptr)
    JUMP

// ---- value parsers: parser(retdest) -> value_ptr

global parse_storage_value:
    // stack: retdest
    PUSH 1
    %trie_alloc                  // [vptr, retdest]
    PROVER_INPUT                 // [value, vptr, retdest]
    DUP2
    %trie_write                  // [vptr, retdest]
    %stack (vptr, retdest) -> (retdest, vptr)
    JUMP

global parse_bytes_value:
    // stack: retdest
    PROVER_INPUT                 // [len, retdest]
    DUP1
    PUSH 1
    ADD
    %trie_alloc                  // [vptr, len, retdest]
    %stack (vptr, len) -> (vptr, len, len, vptr)
    %trie_write                  // [len, vptr, retdest]
    PUSH 0
pbv_loop:
    // stack: i, len, vptr, retdest
    DUP2
    DUP2
    EQ
    %jumpi(pbv_done)
    PROVER_INPUT                 // [b, i, len, vptr, retdest]
    %stack (b, i, len, vptr) -> (vptr, 1, i, b, i, len, vptr)
    ADD
    ADD                          // [vptr+1+i, b, i, len, vptr]
    %trie_write                  // [i, len, vptr, retdest]
    PUSH 1
    ADD
    %jump(pbv_loop)
pbv_done:
    %stack (i, len, vptr, retdest) -> (retdest, vptr)
    JUMP

global parse_account_value:
    // stack: retdest — inputs: nonce, balance, <storage trie>, code_hash
    PUSH 4
    %trie_alloc                  // [vptr, retdest]
    PROVER_INPUT                 // [nonce, vptr, retdest]
    DUP2
    %trie_write                  // [vptr, retdest]
    PROVER_INPUT                 // [balance, vptr, retdest]
    %stack (bal, vptr) -> (vptr, 1, bal, vptr)
    ADD
    %trie_write                  // [vptr, retdest]
    %stack (vptr) -> (parse_storage_value, pav_ret, vptr)
    %jump(mpt_load_node)
pav_ret:
    // stack: sptr, vptr, retdest
    %stack (sptr, vptr) -> (vptr, 2, sptr, vptr)
    ADD
    %trie_write                  // [vptr, retdest]
    PROVER_INPUT                 // [code_hash_be, vptr, retdest]
    %stack (ch, vptr) -> (vptr, 3, ch, vptr)
    ADD
    %trie_write
    %stack (vptr, retdest) -> (retdest, vptr)
    JUMP

// load_all_tries(retdest): state, txn, receipt tries from the prover
// input stream into the global trie pointers (mpt.rs:40 order).
global load_all_tries:
    // reserve trie ptr 0 as null
    PUSH 1
    %mstore_global(@GLOBAL_TRIE_ALLOC)
    %stack (retdest) -> (parse_account_value, lat_1, retdest)
    %jump(mpt_load_node)
lat_1:
    // stack: state_ptr, retdest
    %mstore_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (retdest) -> (parse_bytes_value, lat_2, retdest)
    %jump(mpt_load_node)
lat_2:
    %mstore_global(@GLOBAL_TXN_TRIE_PTR)
    %stack (retdest) -> (parse_bytes_value, lat_3, retdest)
    %jump(mpt_load_node)
lat_3:
    %mstore_global(@GLOBAL_RECEIPT_TRIE_PTR)
    JUMP

// ------------------------------------------------------------- hashing

// mpt_hash(ptr, encoder, retdest) -> digest_le
// encoder(vptr, retdest) -> (addr, len): the value's RLP item bytes.
global mpt_hash:
    // stack: ptr, encoder, retdest
    DUP1
    %trie_read                   // [type, ptr, encoder, retdest]
    PUSH @MPT_HASH
    EQ
    %jumpi(mpt_hash_hashnode)
    %stack (ptr, encoder) -> (ptr, encoder, mpt_hash_enc)
    %jump(encode_node)
mpt_hash_enc:
    // stack: addr, len, retdest
    %stack (addr, len) -> (@SEGMENT_RLP, addr, len)
    KECCAK_GENERAL               // [digest_le, retdest]
    SWAP1
    JUMP
mpt_hash_hashnode:
    // stack: ptr, encoder, retdest — stored digest is a BE word
    PUSH 1
    ADD
    %trie_read                   // [digest_be, encoder, retdest]
    %stack (d, encoder) -> (d, mpt_hash_swapped)
    %jump(byteswap32)
mpt_hash_swapped:
    // stack: digest_le, retdest
    SWAP1
    JUMP

// encode_node(ptr, encoder, retdest) -> (addr, len): the node's RLP
// encoding in SEG_RLP (HASH nodes are referenced, never encoded).
global encode_node:
    // stack: ptr, encoder, retdest
    DUP1
    %trie_read                   // [type, ptr, encoder, retdest]
    DUP1
    PUSH @MPT_EMPTY
    EQ
    %jumpi(encode_empty)
    DUP1
    PUSH @MPT_BRANCH
    EQ
    %jumpi(encode_branch)
    DUP1
    PUSH @MPT_EXTENSION
    EQ
    %jumpi(encode_ext)
    DUP1
    PUSH @MPT_LEAF
    EQ
    %jumpi(encode_leaf)
    %jump(panic)

encode_empty:
    // stack: type, ptr, encoder, retdest
    PUSH 1
    %rlp_alloc                   // [addr, type, ptr, encoder, retdest]
    %stack (addr, type, ptr, encoder) -> (addr, 0x80, addr)
    %rlp_write                   // [addr, retdest]
    %stack (addr, retdest) -> (retdest, addr, 1)
    JUMP

// child_ref(ptr, encoder, retdest) -> (addr, len): the node's
// reference as a parent-list item — inline when its encoding is < 32
// bytes, else 0xa0 || keccak (spec n(J, i)).
global child_ref:
    // stack: ptr, encoder, retdest
    DUP1
    %trie_read                   // [type, ptr, encoder, retdest]
    PUSH @MPT_HASH
    EQ
    %jumpi(child_ref_hash)
    %stack (ptr, encoder) -> (ptr, encoder, child_ref_enc_ret)
    %jump(encode_node)
child_ref_enc_ret:
    // stack: addr, len, retdest
    DUP2
    PUSH 32
    GT                           // 32 > len  <=>  inline
    %jumpi(child_ref_inline)
    %stack (addr, len) -> (@SEGMENT_RLP, addr, len)
    KECCAK_GENERAL               // [digest_le, retdest]
    %stack (d) -> (d, child_ref_swapped)
    %jump(byteswap32)
child_ref_swapped:
    // stack: digest_be, retdest
    %jump(write_hash_ref)
child_ref_inline:
    %stack (addr, len, retdest) -> (retdest, addr, len)
    JUMP
child_ref_hash:
    // stack: ptr, encoder, retdest
    %stack (ptr, encoder) -> (ptr, 1)
    ADD
    %trie_read                   // [digest_be, retdest]
    %jump(write_hash_ref)

// write_hash_ref(digest_be, retdest) -> (addr, 33): 0xa0 || digest
global write_hash_ref:
    PUSH 33
    %rlp_alloc                   // [a, digest, retdest]
    DUP1
    PUSH 0xa0
    SWAP1
    %rlp_write                   // [a, digest, retdest]
    %stack (a, digest) -> (a, 1, digest, 32, whr_ret, a)
    ADD
    %jump(mstore_be)
whr_ret:
    // stack: a, retdest
    %stack (a, retdest) -> (retdest, a, 33)
    JUMP

// ---- branch encoding: 17 (addr, len) pieces via a SEG_TRIE scratch

encode_branch:
    // stack: type, ptr, encoder, retdest
    POP
    PUSH 34
    %trie_alloc                  // [scratch, ptr, encoder, retdest]
    PUSH 0                       // child index i
enc_br_loop:
    // stack: i, scratch, ptr, encoder, retdest
    DUP1
    PUSH 16
    EQ
    %jumpi(enc_br_value)
    %stack (i, scratch, ptr, encoder) -> (ptr, 1, i, i, scratch, ptr, encoder)
    ADD
    ADD                          // [ptr+1+i, i, scratch, ptr, encoder]
    %trie_read                   // [child, i, scratch, ptr, encoder]
    %stack (child, i, scratch, ptr, encoder) -> (child, encoder, enc_br_child_ret, i, scratch, ptr, encoder)
    %jump(child_ref)
enc_br_child_ret:
    // stack: addr, len, i, scratch, ptr, encoder, retdest
    %stack (addr, len, i, scratch) -> (i, i, scratch, addr, len, i, scratch)
    ADD
    ADD                          // [scratch+2i, addr, len, i, scratch]
    DUP1                         // [s2i, s2i, addr, len, i, scratch]
    %stack (s2ia, s2ib, addr, len) -> (s2ia, addr, s2ib, 1, len)
    %trie_write                  // [s2i, 1, len, i, scratch, ...]
    ADD                          // [s2i+1, len, i, scratch, ...]
    %trie_write                  // [i, scratch, ptr, encoder, retdest]
    PUSH 1
    ADD
    %jump(enc_br_loop)
enc_br_value:
    // stack: i, scratch, ptr, encoder, retdest
    POP
    %stack (scratch, ptr, encoder) -> (ptr, 17, scratch, encoder)
    ADD
    %trie_read                   // [vptr, scratch, encoder, retdest]
    DUP1
    ISZERO
    %jumpi(enc_br_no_value)
    %stack (vptr, scratch, encoder) -> (encoder, vptr, enc_br_value_ret, scratch)
    JUMP                         // encoder(vptr) -> (addr, len)
enc_br_no_value:
    // stack: vptr(0), scratch, encoder, retdest
    %stack (vptr, scratch, encoder) -> (scratch)
    PUSH 1
    %rlp_alloc                   // [addr, scratch, retdest]
    DUP1
    PUSH 0x80
    SWAP1
    %rlp_write                   // [addr, scratch, retdest]
    PUSH 1
    SWAP1                        // [addr, 1, scratch, retdest]
enc_br_value_ret:
    // stack: addr, len, scratch, retdest
    %stack (addr, len, scratch) -> (scratch, 32, addr, scratch, len, scratch)
    ADD
    %trie_write                  // [scratch, len, scratch, retdest]
    PUSH 33
    ADD
    %trie_write                  // [scratch, retdest]
    %stack (scratch) -> (scratch, 17)
    %jump(cat_items)

// cat_items(scratch, n, retdest) -> (addr, len): concatenate the n RLP
// pieces whose (addr, len) pairs sit at TRIE[scratch+2k], [scratch+2k+1]
// into one fresh list item: list header + copied payload.
global cat_items:
    PUSH 0                       // total
    PUSH 0                       // k
cat_sum_loop:
    // stack: k, total, scratch, n, retdest
    DUP4
    DUP2
    EQ
    %jumpi(cat_sum_done)
    %stack (k, total, scratch) -> (k, k, 1, scratch, total, k, scratch)
    ADD
    ADD
    ADD                          // [scratch+2k+1, total, k, scratch]
    %trie_read                   // [len_k, total, k, scratch]
    ADD                          // [total', k, scratch]
    SWAP1
    PUSH 1
    ADD
    %jump(cat_sum_loop)
cat_sum_done:
    // stack: k, total, scratch, n, retdest
    POP
    %stack (total, scratch, n) -> (total, cat_hdr, total, scratch, n)
    %jump(rlp_list_header)
cat_hdr:
    // stack: haddr, hlen, total, scratch, n, retdest
    DUP3
    %rlp_alloc                   // [dst, haddr, hlen, total, scratch, n]
    %stack (dst, haddr, hlen, total, scratch, n) -> (dst, 0, scratch, n, haddr, hlen, total)
cat_copy_loop:
    // stack: dst, k, scratch, n, haddr, hlen, total, retdest
    DUP4
    DUP3
    EQ
    %jumpi(cat_copy_done)
    %stack (dst, k, scratch) -> (k, k, scratch, dst, k, scratch)
    ADD
    ADD                          // [scratch+2k, dst, k, scratch]
    DUP1
    %trie_read                   // [src, s2k, dst, k, scratch]
    SWAP1
    PUSH 1
    ADD
    %trie_read                   // [len, src, dst, k, scratch]
    %stack (len, src, dst, k, scratch) -> (dst, src, len, cat_copy_ret, len, dst, k, scratch)
    %jump(rlp_memcpy)
cat_copy_ret:
    // stack: len, dst, k, scratch, n, haddr, hlen, total, retdest
    ADD                          // [dst+len, k, scratch, ...]
    SWAP1
    PUSH 1
    ADD
    SWAP1                        // [dst', k+1, scratch, ...]
    %jump(cat_copy_loop)
cat_copy_done:
    // stack: dst, k, scratch, n, haddr, hlen, total, retdest
    %stack (dst, k, scratch, n, haddr, hlen, total, retdest) -> (hlen, total, retdest, haddr)
    ADD                          // [rlen, retdest, haddr]
    %stack (rlen, retdest, haddr) -> (retdest, haddr, rlen)
    JUMP

// ---- leaf / extension encoding: [hp_item, value-or-child item]

encode_leaf:
    // stack: type, ptr, encoder, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [count, ptr, encoder, retdest]
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [packed, count, ptr, encoder]
    %stack (packed, count, ptr, encoder) -> (count, packed, 1, enc_leaf_k, ptr, encoder)
    %jump(hp_item)
enc_leaf_k:
    // stack: kaddr, klen, ptr, encoder, retdest
    %stack (kaddr, klen, ptr, encoder) -> (ptr, 3, encoder, kaddr, klen)
    ADD
    %trie_read                   // [vptr, encoder, kaddr, klen, retdest]
    %stack (vptr, encoder) -> (encoder, vptr, enc_two_items)
    JUMP                         // encoder(vptr)

encode_ext:
    // stack: type, ptr, encoder, retdest
    POP
    DUP1
    PUSH 1
    ADD
    %trie_read
    DUP2
    PUSH 2
    ADD
    %trie_read
    %stack (packed, count, ptr, encoder) -> (count, packed, 0, enc_ext_k, ptr, encoder)
    %jump(hp_item)
enc_ext_k:
    // stack: kaddr, klen, ptr, encoder, retdest
    %stack (kaddr, klen, ptr, encoder) -> (ptr, 3, encoder, kaddr, klen)
    ADD
    %trie_read                   // [child, encoder, kaddr, klen, retdest]
    %stack (child, encoder) -> (child, encoder, enc_two_items)
    %jump(child_ref)

enc_two_items:
    // stack: vaddr, vlen, kaddr, klen, retdest
    PUSH 4
    %trie_alloc                  // [scratch, vaddr, vlen, kaddr, klen, retdest]
    // pairs in RLP order: [hp_key item, value item]
    %stack (scratch, vaddr, vlen, kaddr, klen) -> (scratch, kaddr, scratch, 1, klen, scratch, 2, vaddr, scratch, 3, vlen, scratch)
    %trie_write                  // scratch[0] = kaddr
    ADD
    %trie_write                  // scratch[1] = klen
    ADD
    %trie_write                  // scratch[2] = vaddr
    ADD
    %trie_write                  // scratch[3] = vlen  -> [scratch, retdest]
    %stack (scratch) -> (scratch, 2)
    %jump(cat_items)

// hp_item(count, packed, is_leaf, retdest) -> (addr, len): the
// hex-prefix key string as an RLP item (yellow paper appendix C).
global hp_item:
    // stack: count, packed, is_leaf, retdest
    %stack (count, packed, is_leaf) -> (count, 1, 2, is_leaf, count, packed)
    AND                          // [odd, 2, is_leaf, count, packed]
    %stack (odd, two, is_leaf) -> (two, is_leaf, odd)
    MUL
    ADD                          // [flag, count, packed, retdest]
    DUP2
    PUSH 2
    GT                           // 2 > count  <=>  hp is one byte
    %jumpi(hp_single)
    // nb = count >> 1 ; alloc 1(header) + 1(b0) + nb
    %stack (flag, count, packed) -> (1, count, flag, count, packed)
    SHR                          // [nb, flag, count, packed]
    DUP1
    PUSH 2
    ADD                          // [nb+2, nb, flag, count, packed]
    %rlp_alloc                   // [addr, nb, flag, count, packed, retdest]
    // RLP[addr] = 0x80 + 1 + nb
    DUP2
    PUSH 0x81
    ADD                          // [hdr, addr, nb, flag, count, packed]
    DUP2
    %rlp_write                   // [addr, nb, flag, count, packed, retdest]
    %stack (addr, nb, flag, count, packed) -> (count, 1, addr, nb, flag, count, packed)
    AND                          // [odd, addr, nb, flag, count, packed]
    %jumpi(hp_odd)
    // even: b0 = flag << 4 ; rest = packed (nb bytes)
    %stack (addr, nb, flag, count, packed) -> (4, flag, 1, addr, addr, nb, packed)
    SHL                          // [b0, 1, addr, addr, nb, packed]
    SWAP1                        // [1, b0, addr, addr, nb, packed]
    DUP3
    ADD                          // [addr+1, b0, addr, addr, nb, packed]
    %rlp_write                   // [addr, addr, nb, packed, retdest]
    POP                          // [addr, nb, packed, retdest]
    %stack (addr, nb, packed) -> (addr, 2, packed, nb, hp_done, addr, nb)
    ADD
    %jump(mstore_be)             // mstore_be(addr+2, packed, nb)
hp_odd:
    // stack: addr, nb, flag, count, packed, retdest
    // first = packed >> 4(count-1) ; b0 = (flag<<4) | first
    // rest = packed & ((1 << 4(count-1)) - 1)
    %stack (addr, nb, flag, count, packed) -> (count, 1, packed, flag, addr, nb, packed)
    SUB                          // [count-1, packed, flag, addr, nb, packed]
    PUSH 4
    MUL                          // [s, packed, flag, addr, nb, packed]
    DUP1
    %stack (s1, s2, packed) -> (s2, packed, s1)
    SHR                          // [first, s, flag, addr, nb, packed]
    %stack (first, s, flag) -> (4, flag, first, s)
    SHL                          // [flag<<4, first, s, addr, nb, packed]
    ADD                          // [b0, s, addr, nb, packed]
    %stack (b0, s, addr, nb, packed) -> (s, 1, 1, packed, b0, addr, nb)
    SHL                          // [1<<s, 1, packed, b0, addr, nb]
    SUB                          // [(1<<s)-1, packed, b0, addr, nb]
    AND                          // [rest, b0, addr, nb, retdest]
    %stack (rest, b0, addr, nb) -> (1, addr, b0, rest, addr, nb)
    ADD                          // [addr+1, b0, rest, addr, nb]
    %rlp_write                   // [rest, addr, nb, retdest]
    %stack (rest, addr, nb) -> (addr, 2, rest, nb, hp_done, addr, nb)
    ADD
    %jump(mstore_be)             // mstore_be(addr+2, rest, nb)
hp_done:
    // stack: addr, nb, retdest
    %stack (addr, nb, retdest) -> (2, nb, retdest, addr)
    ADD                          // [len, retdest, addr]
    %stack (len, retdest, addr) -> (retdest, addr, len)
    JUMP
hp_single:
    // stack: flag, count, packed, retdest — count <= 1: the hp string
    // is the single byte (flag<<4)|nibble < 0x40, so it is its own RLP
    // encoding (no string header)
    PUSH 1
    %rlp_alloc                   // [addr, flag, count, packed, retdest]
    %stack (addr, flag, count, packed) -> (4, flag, packed, addr, addr)
    SHL                          // [flag<<4, packed, addr, addr]
    ADD                          // [b0, addr, addr]
    SWAP1                        // [addr, b0, addr]
    %rlp_write                   // [addr, retdest]
    %stack (addr, retdest) -> (retdest, addr, 1)
    JUMP

// ---- value encoders: encoder(vptr, retdest) -> (addr, len)

// rlp_wrap_string(ia, il, retdest) -> (addr, len): RLP string item
// whose payload is RLP[ia..ia+il).
global rlp_wrap_string:
    // stack: ia, il, retdest
    DUP2
    PUSH 1
    EQ
    %jumpi(rws_maybe_single)
rws_general:
    %stack (ia, il) -> (il, rws_hdr, ia, il)
    %jump(rlp_string_header)
rws_hdr:
    // stack: haddr, hlen, ia, il, retdest
    DUP4
    %rlp_alloc                   // [dst, haddr, hlen, ia, il]
    %stack (dst, haddr, hlen, ia, il) -> (dst, ia, il, rws_cp, haddr, hlen, il)
    %jump(rlp_memcpy)
rws_cp:
    // stack: haddr, hlen, il, retdest
    %stack (haddr, hlen, il, retdest) -> (hlen, il, retdest, haddr)
    ADD
    %stack (rlen, retdest, haddr) -> (retdest, haddr, rlen)
    JUMP
rws_maybe_single:
    // stack: ia, il, retdest
    DUP1
    %rlp_read                    // [byte, ia, il, retdest]
    PUSH 0x80
    GT                           // 0x80 > byte  <=>  no header needed
    %jumpi(rws_identity)
    %jump(rws_general)
rws_identity:
    %stack (ia, il, retdest) -> (retdest, ia, il)
    JUMP

global encode_storage_value:
    // stack: vptr, retdest — leaf value is rlp(word) as a string item
    %trie_read                   // [value, retdest]
    %stack (value) -> (value, esv_inner)
    %jump(rlp_scalar)
esv_inner:
    // stack: ia, il, retdest
    %jump(rlp_wrap_string)

global encode_bytes_value:
    // stack: vptr, retdest — raw bytes as a string item
    DUP1
    %trie_read                   // [len, vptr, retdest]
    DUP1
    %rlp_alloc                   // [ba, len, vptr, retdest]
    PUSH 0
ebv_loop:
    // stack: i, ba, len, vptr, retdest
    DUP3
    DUP2
    EQ
    %jumpi(ebv_done)
    %stack (i, ba, len, vptr) -> (vptr, 1, i, ba, i, i, ba, len, vptr)
    ADD
    ADD                          // [vptr+1+i, ba, i, i, ba, len, vptr]
    %trie_read                   // [b, ba, i, i, ba, len, vptr]
    %stack (b, ba, i) -> (ba, i, b)
    ADD                          // [ba+i, b, i, ba, len, vptr]
    %rlp_write                   // [i, ba, len, vptr, retdest]
    PUSH 1
    ADD
    %jump(ebv_loop)
ebv_done:
    // stack: i, ba, len, vptr, retdest
    %stack (i, ba, len, vptr) -> (ba, len)
    %jump(rlp_wrap_string)

global encode_account_value:
    // stack: vptr, retdest — list [nonce, balance, sroot32, chash32].
    // Pieces accumulate as (addr, len) pairs in a 4-slot scratch table
    // (keeps live stack depth well under the DUP16 reach).
    PUSH 8
    %trie_alloc                  // [scratch, vptr, retdest]
    SWAP1                        // [vptr, scratch, retdest]
    DUP1
    %trie_read                   // [nonce, vptr, scratch, retdest]
    %stack (nonce) -> (nonce, eav_1)
    %jump(rlp_scalar)
eav_1:
    // stack: na, nl, vptr, scratch, retdest
    %stack (na, nl, vptr, scratch) -> (scratch, na, scratch, 1, nl, vptr, scratch)
    %trie_write                  // scratch[0] = na
    ADD
    %trie_write                  // scratch[1] = nl  -> [vptr, scratch, retdest]
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [balance, vptr, scratch, retdest]
    %stack (bal) -> (bal, eav_2)
    %jump(rlp_scalar)
eav_2:
    // stack: ba, bl, vptr, scratch, retdest
    %stack (ba, bl, vptr, scratch) -> (scratch, 2, ba, scratch, 3, bl, vptr, scratch)
    ADD
    %trie_write                  // scratch[2] = ba
    ADD
    %trie_write                  // scratch[3] = bl  -> [vptr, scratch, retdest]
    DUP1
    PUSH 2
    ADD
    %trie_read                   // [sptr, vptr, scratch, retdest]
    %stack (sptr) -> (sptr, encode_storage_value, eav_3)
    %jump(mpt_hash)
eav_3:
    // stack: sroot_le, vptr, scratch, retdest
    %stack (d) -> (d, eav_4)
    %jump(byteswap32)
eav_4:
    // stack: sroot_be, vptr, scratch, retdest
    %stack (d) -> (d, eav_5)
    %jump(write_hash_ref)
eav_5:
    // stack: sa, sl(=33), vptr, scratch, retdest
    %stack (sa, sl, vptr, scratch) -> (scratch, 4, sa, scratch, 5, sl, vptr, scratch)
    ADD
    %trie_write                  // scratch[4] = sa
    ADD
    %trie_write                  // scratch[5] = 33  -> [vptr, scratch, retdest]
    PUSH 3
    ADD
    %trie_read                   // [chash_be, scratch, retdest]
    %stack (ch) -> (ch, eav_6)
    %jump(write_hash_ref)
eav_6:
    // stack: ca, cl(=33), scratch, retdest
    %stack (ca, cl, scratch) -> (scratch, 6, ca, scratch, 7, cl, scratch)
    ADD
    %trie_write                  // scratch[6] = ca
    ADD
    %trie_write                  // scratch[7] = 33  -> [scratch, retdest]
    %stack (scratch) -> (scratch, 4, eav_wrap)
    %jump(cat_items)
eav_wrap:
    // stack: addr, len, retdest — the account list is the leaf's VALUE,
    // which sits in the leaf item list as a byte-STRING (the trie
    // stores rlp(account) bytes; node_rlp wraps them again)
    %jump(rlp_wrap_string)

// ---- whole-trie hashes against the claimed global roots

// hash_state_trie(retdest) -> digest_le
global hash_state_trie:
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (ptr, retdest) -> (ptr, encode_account_value, retdest)
    %jump(mpt_hash)

global hash_txn_trie:
    %mload_global(@GLOBAL_TXN_TRIE_PTR)
    %stack (ptr, retdest) -> (ptr, encode_bytes_value, retdest)
    %jump(mpt_hash)

global hash_receipt_trie:
    %mload_global(@GLOBAL_RECEIPT_TRIE_PTR)
    %stack (ptr, retdest) -> (ptr, encode_bytes_value, retdest)
    %jump(mpt_hash)

// check_root(digest_le, global_idx, retdest): panic unless the digest
// equals the claimed public root (outputs-as-checked-inputs binding).
global check_root:
    // stack: digest, idx, retdest — in dry-run mode (host pipeline
    // computing the public after-roots, transfer.py public_values)
    // PUBLISH the computed root instead of checking; the verifier
    // rebuilds the image with @GLOBAL_DRY_RUN = 0, so a dry-run proof
    // can never pass the ROM binding
    %mload_global(@GLOBAL_DRY_RUN)
    %jumpi(cr_store)
    SWAP1
    PUSH @SEGMENT_GLOBAL
    MLOAD_GENERAL                // [claimed, digest, retdest]
    EQ
    ISZERO
    %jumpi(panic)
    JUMP
cr_store:
    // stack: digest, idx, retdest
    SWAP1
    PUSH @SEGMENT_GLOBAL
    MSTORE_GENERAL               // GLOBAL[idx] = digest
    JUMP
