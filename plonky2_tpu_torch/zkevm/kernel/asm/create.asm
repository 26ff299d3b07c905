// Contract creation: CREATE (0xf0) / CREATE2 (0xf5) (twin of reference
// cpu/kernel/asm/core/{create.asm,create_addresses.asm,
// create_contract_account.asm}, re-targeted at the word machine).
//
// Semantics (EVM, with the word-machine code-form reduction):
//   * CREATE address  = keccak(rlp([creator, creator_nonce]))[12:]
//   * CREATE2 address = keccak(0xff ++ creator ++ salt ++
//                              keccak(init_code))[12:]
//   * the creator's nonce bumps BEFORE the init frame and PERSISTS
//     across an init revert (only the frame checkpoint set after the
//     bump is unwound);
//   * collision (existing nonce != 0 or code): push 0, nonce stays
//     bumped;
//   * the init code runs in a fresh context with the new account as
//     its storage context, CALLVALUE = value, empty calldata; its
//     RETURN data becomes the deployed code: code_hash =
//     keccak(returndata), journaled (@J_CODEHASH) so an enclosing
//     revert restores it (a fresh account's @J_CREATE entry deletes
//     the whole account anyway);
//   * init revert / fault: push 0, the revert payload stays readable
//     via RETURNDATA* (EVM), creation + value transfer unwound.
//
// Word-machine reduction (documented): init code and deployed code are
// 33-byte-per-instruction serializations (contract.asm module note);
// a size or returndata length that is not a multiple of 33 PANICs
// (unprovable) rather than deploying undecodable code.
//
// Gas (reduced dynamics): 32000 per CREATE*, + 200 per deployed code
// byte (the EVM code-deposit rate) — charged to the parent frame.
//
// Stack comments list the TOP first.

global sys_create:
    // stack: trap, value, offset, size
    %assert_not_static
    DUP4
    DUP4
    ADD                          // [offset+size, trap, value, offset, size]
    %charge_memory
    %push_ctx_meta(@CTX_ACCT_VPTR)
    %trie_read                   // [nonce, trap, value, offset, size]
    %push_ctx_meta(@CTX_ADDRESS) // [addr, nonce, trap, value, offset, size]
    // rlp([creator, nonce]) over a 2-pair cat_items scratch
    PUSH 4
    %trie_alloc                  // [sc, addr, nonce, ...]
    PUSH 21
    %rlp_alloc                   // [a, sc, addr, nonce, ...]
    DUP1
    PUSH 0x94
    SWAP1
    %rlp_write                   // RLP[a] = 0x94 (20-byte string header)
    DUP3
    DUP2
    PUSH 1
    ADD                          // [a+1, addr, a, sc, addr, nonce, ...]
    %stack (a1, ad) -> (a1, ad, 20, scr_1)
    %jump(mstore_be)
scr_1:
    // stack: a, sc, addr, nonce, trap, value, offset, size
    DUP2
    %trie_write                  // TRIE[sc] = a
    DUP1
    PUSH 1
    ADD
    PUSH 21
    SWAP1
    %trie_write                  // TRIE[sc+1] = 21 ; [sc, addr, nonce, ..]
    DUP3
    %stack (n) -> (n, scr_2)
    %jump(rlp_scalar)
scr_2:
    // stack: ia, il, sc, addr, nonce, trap, value, offset, size
    DUP3
    PUSH 2
    ADD
    %trie_write                  // TRIE[sc+2] = ia ; [il, sc, addr, ...]
    DUP2
    PUSH 3
    ADD
    %trie_write                  // TRIE[sc+3] = il ; [sc, addr, nonce, ..]
    %stack (sc, addr, nonce) -> (sc, 2, scr_3)
    %jump(cat_items)
scr_3:
    // stack: ra, rl, trap, value, offset, size
    %stack (ra, rl) -> (@SEGMENT_RLP, ra, rl)
    KECCAK_GENERAL               // [d_le, trap, value, offset, size]
    %stack (d) -> (d, scr_4)
    %jump(byteswap32)
scr_4:
    PUSH 0xffffffffffffffffffffffffffffffffffffffff
    AND                          // [new_addr, trap, value, offset, size]
    %jump(create_common)

global sys_create2:
    // stack: trap, value, offset, size, salt
    %assert_not_static
    DUP4
    DUP4
    ADD
    %charge_memory
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, trap, value, offset, size, salt]
    %stack (bsw, trap, value, offset, size) -> (bsw, offset, size, trap, value, offset, size)
    KECCAK_GENERAL               // [ih_le, trap, value, offset, size, salt]
    %stack (d) -> (d, sc2_1)
    %jump(byteswap32)
sc2_1:
    // stack: ih, trap, value, offset, size, salt
    PUSH 85
    %rlp_alloc                   // [b, ih, trap, value, offset, size, salt]
    DUP1
    PUSH 0xff
    SWAP1
    %rlp_write                   // RLP[b] = 0xff
    %push_ctx_meta(@CTX_ADDRESS) // [creator, b, ih, ...]
    DUP2
    PUSH 1
    ADD                          // [b+1, creator, b, ih, ...]
    %stack (b1, cr) -> (b1, cr, 20, sc2_2)
    %jump(mstore_be)
sc2_2:
    // stack: b, ih, trap, value, offset, size, salt
    DUP7
    DUP2
    PUSH 21
    ADD                          // [b+21, salt, b, ih, ...]
    %stack (b21, salt) -> (b21, salt, 32, sc2_3)
    %jump(mstore_be)
sc2_3:
    // stack: b, ih, trap, value, offset, size, salt
    DUP2
    DUP2
    PUSH 53
    ADD                          // [b+53, ih, b, ih, ...]
    %stack (b53, ihv) -> (b53, ihv, 32, sc2_4)
    %jump(mstore_be)
sc2_4:
    // stack: b, ih, trap, value, offset, size, salt
    %stack (b, ih) -> (@SEGMENT_RLP, b, 85)
    KECCAK_GENERAL               // [d_le, trap, value, offset, size, salt]
    %stack (d) -> (d, sc2_5)
    %jump(byteswap32)
sc2_5:
    PUSH 0xffffffffffffffffffffffffffffffffffffffff
    AND
    %stack (na, trap, value, offset, size, salt) -> (na, trap, value, offset, size)
    %jump(create_common)

// create_common(new_addr, trap, value, offset, size): the shared tail.
global create_common:
    %mload_global(@GLOBAL_CALL_DEPTH)
    PUSH 1024
    EQ
    %jumpi(cc_fail)
    // EIP-2929: the created address enters the warm set (journaled, so
    // a surrounding revert re-cools it); the result is irrelevant here
    DUP1
    %stack (a) -> (a, cc_acc)
    %jump(warm_addr)
cc_acc:
    POP
    // creator must afford the endowment
    %push_ctx_meta(@CTX_ACCT_VPTR)
    PUSH 1
    ADD
    %trie_read                   // [bal, na, trap, value, offset, size]
    DUP4
    SWAP1
    LT
    %jumpi(cc_fail)
    // nonce bump (journaled; PERSISTS across an init revert — the
    // checkpoint below is recorded AFTER this entry)
    %push_ctx_meta(@CTX_ACCT_VPTR)
    DUP1
    %trie_read                   // [nonce, vptr, na, trap, value, offset, size]
    %stack (nonce, vptr) -> (@J_NONCE, vptr, nonce, 0, cc_1, nonce, vptr)
    %jump(journal_append)
cc_1:
    // stack: nonce, vptr, na, trap, value, offset, size
    PUSH 1
    ADD
    SWAP1
    %trie_write                  // TRIE[vptr] = nonce + 1
    // frame checkpoint: the debit + creation below unwind with the
    // init frame (EVM revert keeps only the nonce bump)
    %mload_global(@GLOBAL_JOURNAL_LEN)
    SWAP1                        // [na, ck, trap, value, offset, size]
    DUP1
    %stack (na) -> (na, cc_2)
    %jump(addr_key)
cc_2:
    // stack: key, na, ck, trap, value, offset, size
    DUP1
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, cc_3)
    %jump(mpt_read)
cc_3:
    // stack: vptr, key, na, ck, trap, value, offset, size
    DUP1
    ISZERO
    %jumpi(cc_fresh)
    // existing account: collision iff nonce != 0 or code present
    DUP1
    %trie_read                   // [nonce, vptr, key, ...]
    %jumpi(cc_fail_pop3)
    DUP1
    PUSH 3
    ADD
    %trie_read                   // [chash, vptr, key, ...]
    PUSH @EMPTY_CODE_HASH
    EQ
    ISZERO
    %jumpi(cc_fail_pop3)
    // balance-only ghost: journal nonce + balance, nonce = 1, bal += v
    DUP1
    %stack (vptr) -> (@J_NONCE, vptr, 0, 0, cc_g1, vptr)
    %jump(journal_append)
cc_g1:
    // stack: vptr, key, na, ck, trap, value, offset, size
    DUP1
    %journal_balance
    DUP1
    PUSH 1
    SWAP1
    %trie_write                  // nonce = 1 (EIP-161)
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [bal, vptr, key, na, ck, trap, value, ...]
    DUP7
    ADD                          // [bal + value, vptr, ...]
    DUP2
    PUSH 1
    ADD
    %trie_write                  // [vptr, key, na, ck, trap, value, offset, size]
    %jump(cc_have)
cc_fresh:
    // stack: vptr(0), key, na, ck, trap, value, offset, size
    POP
    DUP1
    %stack (k) -> (@J_CREATE, k, 0, 0, cc_f1)
    %jump(journal_append)
cc_f1:
    // stack: key, na, ck, trap, value, offset, size
    DUP1
    DUP6
    SWAP1
    %stack (k, v) -> (k, v, cc_f2)
    %jump(credit_account)
cc_f2:
    // stack: key, na, ck, trap, value, offset, size — fresh vptr
    DUP1
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, cc_f3)
    %jump(mpt_read)
cc_f3:
    // stack: vptr, key, na, ck, trap, value, offset, size
    DUP1
    PUSH 1
    SWAP1
    %trie_write                  // nonce = 1 (no journal: @J_CREATE deletes)
cc_have:
    // stack: vptr, key, na, ck, trap, value, offset, size
    // journaled debit of the creator
    %push_ctx_meta(@CTX_ACCT_VPTR)
    DUP1
    %journal_balance
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [bal, cvptr, vptr, key, na, ck, trap, value, ...]
    DUP8
    SWAP1
    SUB                          // [bal - value, cvptr, ...]
    SWAP1
    PUSH 1
    ADD
    %trie_write                  // [vptr, key, na, ck, trap, value, offset, size]
    // init code: whole 33-byte instructions only (module note)
    DUP8
    PUSH 33
    SWAP1
    MOD
    %jumpi(panic)
    // child context, code loaded from the caller's byte memory
    %mload_global(@GLOBAL_NEXT_CTX)
    PUSH 1
    ADD
    DUP1
    %mstore_global(@GLOBAL_NEXT_CTX) // [child, vptr, key, na, ck, trap, value, offset, size]
    DUP9
    PUSH 33
    SWAP1
    DIV                          // [count, child, vptr, ...]
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, count, child, vptr, key, na, ck, trap, value, offset, size]
    DUP10
    %stack (offset, bsw, count, child) -> (child, bsw, offset, count, cc_4, child)
    %jump(load_code_from_memory)
cc_4:
    // stack: child, vptr, key, na, ck, trap, value, offset, size
    %mload_global(@GLOBAL_CALL_DEPTH)
    PUSH 1
    ADD
    %mstore_global(@GLOBAL_CALL_DEPTH)
    DUP1
    %seg_of(@SEGMENT_CTX_META)   // [cmsw, child, vptr, key, na, ck, trap, value, offset, size]
    %stack (cmsw, child, vptr) -> (cmsw, @CTX_ACCT_VPTR, vptr, cmsw, child)
    MSTORE_GENERAL               // [cmsw, child, key, na, ck, trap, value, offset, size]
    DUP4
    %stack (na, cmsw) -> (cmsw, @CTX_ADDRESS, na, cmsw)
    MSTORE_GENERAL
    %push_ctx_meta(@CTX_ADDRESS)
    %stack (cr, cmsw) -> (cmsw, @CTX_CALLER, cr, cmsw)
    MSTORE_GENERAL
    DUP7
    %stack (v, cmsw) -> (cmsw, @CTX_CALLVALUE, v, cmsw)
    MSTORE_GENERAL
    GET_CONTEXT
    %stack (pctx, cmsw) -> (cmsw, @CTX_PARENT_CTX, pctx, cmsw)
    MSTORE_GENERAL
    %stack (cmsw) -> (cmsw, @CTX_PARENT_PC, cc_ret, cmsw)
    MSTORE_GENERAL
    // child limit = remaining - remaining/64 (EVM CREATE forwards
    // all-but-one-64th automatically, core/create.asm)
    %push_ctx_meta(@CTX_GASLIMIT)
    DUP7
    PUSH 192
    SHR                          // [used, limit, cmsw, child, key, na, ck, trap, ...]
    DUP2
    DUP2
    GT                           // [used > limit, used, limit, cmsw, ...]
    %jumpi(ccg_zero)
    SWAP1
    SUB                          // [rem, cmsw, ...]
    DUP1
    PUSH 64
    SWAP1
    DIV
    SWAP1
    SUB                          // [fwd = rem - rem/64, cmsw, ...]
    %jump(ccg_done)
ccg_zero:
    POP
    POP
    PUSH 0
ccg_done:
    %stack (gl, cmsw) -> (cmsw, @CTX_GASLIMIT, gl, cmsw)
    MSTORE_GENERAL
    DUP5
    %stack (ck, cmsw) -> (cmsw, @CTX_CKPT, ck)
    MSTORE_GENERAL               // [child, key, na, ck, trap, value, offset, size]
    // enter the init frame; the parent stack saves [trap, na]
    %stack (child, key, na, ck, trap, value, offset, size) -> (child, trap, na)
    SET_CONTEXT
    PUSH 0
    EXIT_KERNEL
cc_ret:
    // stack: trap, na — the init frame exited, parent restored
    %mload_global(@GLOBAL_CALL_DEPTH)
    PUSH 1
    SWAP1
    SUB
    %mstore_global(@GLOBAL_CALL_DEPTH)
    %mload_global(@GLOBAL_LAST_FRAME_GAS)
    PUSH 192
    SHL
    ADD                          // the init frame's charge -> parent trap
    %mload_global(@GLOBAL_FRAME_STATUS)
    ISZERO
    %jumpi(cc_init_failed)
    // success: deployed code = returndata
    %mload_global(@GLOBAL_RETURNDATA_LEN)
    DUP1
    PUSH 33
    SWAP1
    MOD
    %jumpi(panic)                // undecodable code form (module note)
    DUP1
    ISZERO
    %jumpi(cc_no_code)
    DUP1
    PUSH 0
    PUSH @SEGMENT_RETURNDATA
    KECCAK_GENERAL               // [d_le, rdlen, trap, na]
    %stack (d) -> (d, cc_5)
    %jump(byteswap32)
cc_5:
    // stack: chash, rdlen, trap, na
    DUP4
    %stack (na) -> (na, cc_6)
    %jump(addr_key)
cc_6:
    // stack: key, chash, rdlen, trap, na
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, cc_7)
    %jump(mpt_read)
cc_7:
    // stack: vptr, chash, rdlen, trap, na
    DUP1
    ISZERO
    %jumpi(panic)                // we created it above
    DUP1
    PUSH 3
    ADD
    %trie_read                   // [old, vptr, chash, rdlen, trap, na]
    %stack (old, vptr) -> (@J_CODEHASH, vptr, old, 0, cc_8, vptr)
    %jump(journal_append)
cc_8:
    // stack: vptr, chash, rdlen, trap, na
    PUSH 3
    ADD                          // [vptr+3, chash, rdlen, trap, na]
    %trie_write                  // code_hash = keccak(returndata)
cc_no_code:
    // stack: rdlen, trap, na
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    PUSH 200
    MUL
    PUSH 32000
    ADD                          // [gas, trap, na]
    PUSH 192
    SHL
    ADD                          // [trap', na]
    EXIT_KERNEL
cc_init_failed:
    // stack: trap, na — RETURNDATA keeps the revert payload (EVM)
    %stack (trap, na) -> (trap, 0)
    %charge_gas(32000)
    EXIT_KERNEL
cc_fail_pop3:
    // collision: nonce stays bumped, no state change (EVM)
    // stack: x, vptr, key, na, ck, trap, value, offset, size
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %stack (x, vptr, key, na, ck, trap, value, offset, size) -> (trap, 0)
    %charge_gas(32000)
    EXIT_KERNEL
cc_fail:
    // depth / balance: no state change at all
    // stack: na, trap, value, offset, size
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %stack (na, trap, value, offset, size) -> (trap, 0)
    %charge_gas(32000)
    EXIT_KERNEL

// load_code_from_memory(child, bsw, offset, count, retdest): decode
// `count` 33-byte instructions from the byte segment `bsw` at offset
// into the child's CODE words + JUMPDEST bits (load_contract_code's
// memory-sourced twin — no hash check: the bytes come from proven
// memory).
global load_code_from_memory:
    // stack: child, bsw, offset, count, retdest
    DUP1
    %seg_of(@SEGMENT_CODE)       // [csw, child, bsw, offset, count, retdest]
    SWAP1
    %seg_of(@SEGMENT_JUMPDEST)   // [jsw, csw, bsw, offset, count, retdest]
    %stack (jsw, csw) -> (0, csw, jsw)
    // stack: i, csw, jsw, bsw, offset, count, retdest
lcm_loop:
    DUP6
    DUP2
    EQ
    %jumpi(lcm_done)
    DUP1
    PUSH 33
    MUL
    DUP6
    ADD                          // [c = offset + 33i, i, csw, jsw, bsw, offset, count]
    DUP1
    DUP6
    MLOAD_GENERAL                // [op, c, i, csw, jsw, bsw, offset, count]
    %stack (op, c, i, csw) -> (i, i, csw, op, op, c, i, csw)
    ADD
    SWAP1
    MSTORE_GENERAL               // CODE[2i] = op ; [op, c, i, csw, jsw, ..]
    PUSH 0x5b
    EQ
    ISZERO
    %jumpi(lcm_imm)
    %stack (c, i, csw, jsw) -> (jsw, i, 1, c, i, csw, jsw)
    MSTORE_GENERAL               // JUMPDEST[i] = 1
lcm_imm:
    // stack: c, i, csw, jsw, bsw, offset, count
    PUSH 1
    ADD
    DUP5
    SWAP1                        // [c+1, bsw, i, csw, jsw, bsw, offset, count]
    %stack (c1, bsw) -> (bsw, c1, 32, lcm_2)
    %jump(mload_be_gen)
lcm_2:
    // stack: imm, i, csw, jsw, bsw, offset, count, retdest
    %stack (imm, i, csw) -> (i, i, 1, csw, imm, i, csw)
    ADD
    ADD                          // [2i+1, csw, imm, i, csw, jsw, ...]
    SWAP1
    MSTORE_GENERAL               // CODE[2i+1] = imm
    PUSH 1
    ADD
    %jump(lcm_loop)
lcm_done:
    %stack (i, csw, jsw, bsw, offset, count, retdest) -> (retdest)
    JUMP
