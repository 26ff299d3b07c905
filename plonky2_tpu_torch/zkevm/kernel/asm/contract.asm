// Contract execution in a sub-context (reduced twin of reference
// cpu/kernel/asm/core/{call.asm,process_txn.asm} + journal/journal.asm
// + core/jumpdest_analysis.asm, re-targeted at the word machine).
//
// Flow (txn.asm execute_transfer tail): when the txn recipient's
// account carries code (code_hash != keccak("")), the kernel
//   1. loads the code from the prover-input stream into the fresh
//     context's CODE segment, verifying keccak(serialization) against
//     the account's code_hash (the reference reads code the same way,
//     generation/prover_input.rs) and writing the context's JUMPDEST
//     bits (jumpdest_analysis.asm equivalent);
//   2. copies the public txn calldata (SEG_GLOBAL words) into the
//     context's CALLDATA bytes and seeds the context metadata
//     (address/caller/value/calldata size, account vptr);
//   3. enters the context: SET_CONTEXT swaps SP through META_SP
//     (cpu.py), then EXIT_KERNEL with word 0 starts user execution at
//     pc 0 with zero gas;
//   4. the contract exits through sys_stop / sys_return / sys_revert
//     (or a user fault -> fault_exception), all of which land in
//     contract_exit below: copy returndata, set the failure flag,
//     journal-revert if failing, SET_CONTEXT back to 0 (the parent's
//     SP was hardware-saved on entry) and jump to the stored
//     continuation.
//
// Journal (reference journal/journal.asm redesign): fixed 4-cell
// entries [type, a, b, c] in (0, SEG_JOURNAL); revert REPLAYS the old
// values through the same trie routines rather than snapshotting
// pointers (mpt_insert mutates nodes in place, but trie HASHES are
// content-based, so value-replay restores the root exactly).
// Fresh-key inserts (absent storage slot @J_SABSENT, created account
// @J_CREATE) revert through mpt_ops.asm mpt_delete (round 5 — this
// closed the round-4 value-replay completeness gap).
//
// Code serialization for hashing: 33 bytes per instruction — opcode
// byte, then the immediate as 32 big-endian bytes.  code_hash =
// keccak of that byte string, stored big-endian in the account.
//
// Stack comments list the TOP first.

// [x] -> [segword]: segword addressing segment $seg of context x
// (segword = ctx<<32 | seg; opcodes.py round-4 note)
%macro seg_of(seg)
    PUSH 32
    SHL
    PUSH $seg
    ADD
%endmacro

// ------------------------------------------------------------ journal

// journal_append(type, a, b, c, retdest): append one 4-cell entry
global journal_append:
    %mload_global(@GLOBAL_JOURNAL_LEN)
    DUP1
    PUSH 1
    ADD
    %mstore_global(@GLOBAL_JOURNAL_LEN)
    // stack: len, type, a, b, c, retdest
    PUSH 4
    MUL                          // [base, type, a, b, c, retdest]
    %stack (base, type) -> (base, type, base)
    PUSH @SEGMENT_JOURNAL
    MSTORE_GENERAL               // JOURNAL[base] = type
    // stack: base, a, b, c, retdest
    %stack (base, a) -> (base, 1, a, base)
    ADD
    PUSH @SEGMENT_JOURNAL
    MSTORE_GENERAL               // JOURNAL[base+1] = a
    %stack (base, b) -> (base, 2, b, base)
    ADD
    PUSH @SEGMENT_JOURNAL
    MSTORE_GENERAL               // JOURNAL[base+2] = b
    %stack (base, c) -> (base, 3, c)
    ADD
    PUSH @SEGMENT_JOURNAL
    MSTORE_GENERAL               // JOURNAL[base+3] = c
    JUMP

// [vptr] -> []: record the old balance of the account at vptr
%macro journal_balance
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [old_bal, vptr]
    %stack (old, vptr) -> (@J_BALANCE, vptr, old, 0, %%done)
    %jump(journal_append)
%%done:
%endmacro

// revert_journal(retdest): unwind entries above @GLOBAL_JOURNAL_CKPT,
// newest first (journal/revert.asm revert_journal_entry dispatch)
global revert_journal:
rj_loop:
    %mload_global(@GLOBAL_JOURNAL_LEN)
    %mload_global(@GLOBAL_JOURNAL_CKPT)
    // stack: ckpt, len, retdest
    DUP2
    EQ
    %jumpi(rj_done)
    PUSH 1

    SWAP1
    SUB                          // [len-1, retdest]
    DUP1
    %mstore_global(@GLOBAL_JOURNAL_LEN)
    PUSH 4
    MUL                          // [base, retdest]
    DUP1
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [type, base, retdest]
    DUP1
    PUSH @J_BALANCE
    EQ
    %jumpi(rj_balance)
    DUP1
    PUSH @J_STORAGE
    EQ
    %jumpi(rj_storage)
    DUP1
    PUSH @J_SABSENT
    EQ
    %jumpi(rj_sabsent)
    DUP1
    PUSH @J_CREATE
    EQ
    %jumpi(rj_create)
    DUP1
    PUSH @J_LOG
    EQ
    %jumpi(rj_log)
    DUP1
    PUSH @J_NONCE
    EQ
    %jumpi(rj_nonce)
    DUP1
    PUSH @J_CODEHASH
    EQ
    %jumpi(rj_codehash)
    DUP1
    PUSH @J_REFUND
    EQ
    %jumpi(rj_refund)
    DUP1
    PUSH @J_ALIST
    EQ
    %jumpi(rj_alist)
    PUSH @J_SLIST
    EQ
    %jumpi(rj_slist)
    %jump(panic)
rj_alist:
    // stack: type, base, retdest — entry [_, old_len, _, _]: re-cool
    // the addresses warmed inside the reverted frame (EIP-2929)
    POP
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_len, retdest]
    %mstore_global(@GLOBAL_ALIST_LEN)
    %jump(rj_loop)
rj_slist:
    // stack: base, retdest (type consumed by the EQ chain)
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_len, retdest]
    %mstore_global(@GLOBAL_SLIST_LEN)
    %jump(rj_loop)
rj_balance:
    // stack: type, base, retdest — entry [_, vptr, old_bal, _]
    POP
    DUP1
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [vptr, base, retdest]
    SWAP1
    PUSH 2
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_bal, vptr, retdest]
    SWAP1
    PUSH 1
    ADD                          // [vptr+1, old_bal, retdest]
    %trie_write
    %jump(rj_loop)
rj_storage:
    // stack: type, base, retdest — entry [_, acct_vptr, slot, old_value]:
    // replay SSTORE(slot, old_value) on the account's storage trie
    POP
    DUP1
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [acct_vptr, base, retdest]
    DUP2
    PUSH 2
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [slot, acct_vptr, base, retdest]
    SWAP2                        // [base, acct_vptr, slot, retdest]
    PUSH 3
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_value, acct_vptr, slot, retdest]
    %stack (old, vptr, slot) -> (vptr, slot, old, rj_loop)
    %jump(storage_write)
rj_sabsent:
    // stack: type, base, retdest — entry [_, acct_vptr, slot, _]: the
    // slot was ABSENT before the frame wrote it; value-replay cannot
    // express that, so revert DELETES the key (mpt_ops.asm mpt_delete —
    // the round-4 completeness gap this closes)
    POP
    DUP1
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [acct_vptr, base, retdest]
    SWAP1
    PUSH 2
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [slot, acct_vptr, retdest]
    %stack (slot, vptr) -> (vptr, slot, rj_loop)
    %jump(storage_delete)
rj_create:
    // stack: type, base, retdest — entry [_, state_key, 0, 0]: delete
    // the account created inside the reverted frame from the state trie
    POP
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [key, retdest]
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, rj_cr1)
    %jump(mpt_delete)
rj_cr1:
    // stack: newstate, retdest
    %mstore_global(@GLOBAL_STATE_TRIE_PTR)
    %jump(rj_loop)

rj_log:
    // stack: type, base, retdest — entry [_, old_count, old_alloc, _]:
    // truncate the log list back to its pre-frame state (logs.asm)
    POP
    DUP1
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_count, base, retdest]
    %mstore_global(@GLOBAL_LOG_COUNT)
    PUSH 2
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_alloc, retdest]
    %mstore_global(@GLOBAL_LOG_ALLOC)
    %jump(rj_loop)

rj_nonce:
    // stack: type, base, retdest — entry [_, vptr, old_nonce, _]
    POP
    DUP1
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [vptr, base, retdest]
    SWAP1
    PUSH 2
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_nonce, vptr, retdest]
    SWAP1
    %trie_write                  // TRIE[vptr] = old_nonce
    %jump(rj_loop)

rj_codehash:
    // stack: type, base, retdest — entry [_, vptr, old_hash, _]
    POP
    DUP1
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [vptr, base, retdest]
    PUSH 3
    ADD                          // [vptr+3, base, retdest]
    SWAP1
    PUSH 2
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_hash, vptr+3, retdest]
    SWAP1
    %trie_write                  // TRIE[vptr+3] = old_hash
    %jump(rj_loop)

rj_refund:
    // stack: type, base, retdest — entry [_, old_refund, 0, _]
    POP
    PUSH 1
    ADD
    PUSH @SEGMENT_JOURNAL
    MLOAD_GENERAL                // [old_refund, retdest]
    %mstore_global(@GLOBAL_REFUND)
    %jump(rj_loop)

rj_done:
    // stack: len, retdest
    POP
    JUMP

// ------------------------------------------------- storage primitives

// hash_key32(v, retdest) -> packed: 64-nibble storage-trie key
// keccak(32-byte BE v) (reference storage keys; addr_key twin)
global hash_key32:
    // stack: v, retdest
    PUSH 32
    %rlp_alloc                   // [a, v, retdest]
    %stack (a, v) -> (a, v, 32, hk_1, a)
    %jump(mstore_be)
hk_1:
    // stack: a, retdest
    %stack (a) -> (@SEGMENT_RLP, a, 32)
    KECCAK_GENERAL               // [digest_le, retdest]
    %stack (d) -> (d, hk_2)
    %jump(byteswap32)
hk_2:
    SWAP1
    JUMP

// storage_read(acct_vptr, slot, retdest) -> value (0 if absent)
global storage_read:
    // stack: acct_vptr, slot, retdest
    SWAP1
    %stack (slot) -> (slot, sr_1)
    %jump(hash_key32)
sr_1:
    // stack: key, acct_vptr, retdest
    SWAP1
    PUSH 2
    ADD
    %trie_read                   // [sptr, key, retdest]
    %stack (sptr, key) -> (sptr, 64, key, sr_2)
    %jump(mpt_read)
sr_2:
    // stack: vptr, retdest
    DUP1
    ISZERO
    %jumpi(sr_absent)
    %trie_read                   // [value, retdest]
    SWAP1
    JUMP
sr_absent:
    // stack: vptr(0), retdest — absent slot reads 0
    SWAP1
    JUMP

// storage_write(acct_vptr, slot, value, retdest): storage[slot] = value
// (fresh 1-cell trie value + insert; account's storage ptr updated)
global storage_write:
    // stack: acct_vptr, slot, value, retdest
    SWAP1
    %stack (slot) -> (slot, sw_1)
    %jump(hash_key32)
sw_1:
    // stack: key, acct_vptr, value, retdest
    PUSH 1
    %trie_alloc                  // [vv, key, acct_vptr, value, retdest]
    %stack (vv, key, acct_vptr, value) -> (vv, value, acct_vptr, key, vv, acct_vptr)
    %trie_write                  // TRIE[vv] = value
    // stack: acct_vptr, key, vv, acct_vptr, retdest
    PUSH 2
    ADD
    %trie_read                   // [sptr, key, vv, acct_vptr, retdest]
    %stack (sptr, key, vv) -> (sptr, 64, key, vv, sw_2)
    %jump(mpt_insert)
sw_2:
    // stack: newsptr, acct_vptr, retdest
    SWAP1
    PUSH 2
    ADD                          // [acct_vptr+2, newsptr, retdest]
    %trie_write
    JUMP

// storage_probe(acct_vptr, slot, retdest) -> vptr: the slot's trie
// value pointer, 0 when the slot is absent (distinguishes "absent"
// from "stored 0" — sys_sstore journals the difference)
global storage_probe:
    // stack: acct_vptr, slot, retdest
    SWAP1
    %stack (slot) -> (slot, stp_1)
    %jump(hash_key32)
stp_1:
    // stack: key, acct_vptr, retdest
    SWAP1
    PUSH 2
    ADD
    %trie_read                   // [sptr, key, retdest]
    %stack (sptr, key) -> (sptr, 64, key, stp_2)
    %jump(mpt_read)
stp_2:
    SWAP1
    JUMP

// storage_delete(acct_vptr, slot, retdest): remove the slot from the
// account's storage trie (mpt_ops.asm mpt_delete) and store the new
// storage root pointer
global storage_delete:
    // stack: acct_vptr, slot, retdest
    SWAP1
    %stack (slot) -> (slot, sdl_1)
    %jump(hash_key32)
sdl_1:
    // stack: key, acct_vptr, retdest
    DUP2
    PUSH 2
    ADD
    %trie_read                   // [sptr, key, acct_vptr, retdest]
    %stack (sptr, key, acct_vptr) -> (sptr, 64, key, sdl_2, acct_vptr)
    %jump(mpt_delete)
sdl_2:
    // stack: newsptr, acct_vptr, retdest
    SWAP1
    PUSH 2
    ADD                          // [acct_vptr+2, newsptr, retdest]
    %trie_write
    JUMP

// -------------------------------------------------- contract loading

// load_contract_code(chash, child, retdest): read (count, then
// per-instruction opcode+imm) from the prover-input stream, write the
// child's CODE words + JUMPDEST bits, and verify the 33-byte/instr
// serialization hashes to chash.
global load_contract_code:
    // stack: chash, child, retdest
    PROVER_INPUT                 // [count, chash, child, retdest]
    DUP1
    PUSH 33
    MUL                          // [hlen, count, chash, child, retdest]
    DUP1
    %rlp_alloc                   // [hb0, hlen, count, chash, child, retdest]
    DUP5
    %seg_of(@SEGMENT_CODE)       // [csw, hb0, hlen, count, chash, child, retdest]
    DUP6
    %seg_of(@SEGMENT_JUMPDEST)   // [jsw, csw, hb0, hlen, count, chash, child, retdest]
    %stack (jsw, csw, hb0, hlen, count, chash, child) -> (0, hb0, count, csw, jsw, hb0, hlen, chash)
lcc_loop:
    // stack: i, hb, count, csw, jsw, hb0, hlen, chash, retdest
    DUP3
    DUP2
    EQ
    %jumpi(lcc_done)
    PROVER_INPUT                 // [op, i, hb, count, csw, jsw, ...]
    // code word: (child, SEG_CODE, 2i) = op
    %stack (op, i, hb, count, csw) -> (i, i, csw, op, op, i, hb, count, csw)
    ADD                          // [2i, csw, op, op, i, hb, count, csw, ...]
    SWAP1                        // [csw, 2i, op, op, ...]
    MSTORE_GENERAL               // [op, i, hb, count, csw, jsw, ...]
    // hash byte: RLP[hb] = op
    DUP1
    DUP4
    %rlp_write                   // [op, i, hb, count, csw, jsw, ...]
    // jumpdest bit: if op == 0x5B: (child, SEG_JUMPDEST, i) = 1
    PUSH 0x5b
    EQ
    ISZERO
    %jumpi(lcc_imm)
    %stack (i, hb, count, csw, jsw) -> (jsw, i, 1, i, hb, count, csw, jsw)
    MSTORE_GENERAL               // [i, hb, count, csw, jsw, ...]
lcc_imm:
    PROVER_INPUT                 // [imm, i, hb, count, csw, jsw, ...]
    // code word: (child, SEG_CODE, 2i+1) = imm
    %stack (imm, i, hb, count, csw) -> (i, i, 1, csw, imm, imm, i, hb, count, csw)
    ADD
    ADD                          // [2i+1, csw, imm, imm, ...]
    SWAP1                        // [csw, 2i+1, imm, imm, ...]
    MSTORE_GENERAL               // [imm, i, hb, count, csw, jsw, ...]
    // hash bytes: RLP[hb+1 .. hb+32] = imm big-endian
    DUP3
    PUSH 1
    ADD                          // [hb+1, imm, i, hb, count, ...]
    %stack (a, imm) -> (a, imm, 32, lcc_next)
    %jump(mstore_be)
lcc_next:
    // stack: i, hb, count, csw, jsw, hb0, hlen, chash, retdest
    PUSH 1
    ADD                          // [i+1, hb, ...]
    SWAP1
    PUSH 33
    ADD
    SWAP1                        // [i+1, hb+33, ...]
    %jump(lcc_loop)
lcc_done:
    // stack: i, hb, count, csw, jsw, hb0, hlen, chash, retdest
    %stack (i, hb, count, csw, jsw, hb0, hlen, chash) -> (@SEGMENT_RLP, hb0, hlen, chash)
    KECCAK_GENERAL               // [digest_le, chash, retdest]
    %stack (d) -> (d, lcc_cmp)
    %jump(byteswap32)
lcc_cmp:
    // stack: digest_be, chash, retdest
    EQ
    ISZERO
    %jumpi(panic)                // code does not match the account hash
    JUMP

// ---------------------------------------------- context entry / exit

// execute_contract(tkey, retdest): if the account at state key tkey
// carries code, run it in a fresh context (call.asm reduced: the txn
// recipient frame; the journal checkpoint is set by the caller before
// the value transfer so REVERT undoes it, journal/revert.asm).
global execute_contract:
    // stack: tkey, retdest
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, tkey) -> (state, 64, tkey, ec_1)
    %jump(mpt_read)
ec_1:
    // stack: tvptr, retdest
    DUP1
    ISZERO
    %jumpi(ec_skip)              // no account: nothing to execute
    DUP1
    PUSH 3
    ADD
    %trie_read                   // [chash, tvptr, retdest]
    DUP1
    PUSH @EMPTY_CODE_HASH
    EQ
    %jumpi(ec_skip2)             // no code
    // allocate the child context id (ids start at 1; 0 is the kernel)
    %mload_global(@GLOBAL_NEXT_CTX)
    PUSH 1
    ADD                          // [child, chash, tvptr, retdest]
    DUP1
    %mstore_global(@GLOBAL_NEXT_CTX)
    // load + verify the code, write JUMPDEST bits
    %stack (child, chash, tvptr) -> (chash, child, ec_2, child, tvptr)
    %jump(load_contract_code)
ec_2:
    // stack: child, tvptr, retdest — seed the context metadata
    DUP1
    %seg_of(@SEGMENT_CTX_META)   // [msw, child, tvptr, retdest]
    %stack (msw, child, tvptr) -> (msw, @CTX_ACCT_VPTR, tvptr, msw, child, tvptr)
    MSTORE_GENERAL
    %mload_global(@GLOBAL_TXN_TO)
    %stack (to, msw) -> (msw, @CTX_ADDRESS, to, msw)
    MSTORE_GENERAL
    %mload_global(@GLOBAL_TXN_SENDER)
    %stack (from, msw) -> (msw, @CTX_CALLER, from, msw)
    MSTORE_GENERAL
    %mload_global(@GLOBAL_TXN_VALUE)
    %stack (v, msw) -> (msw, @CTX_CALLVALUE, v, msw)
    MSTORE_GENERAL
    %mload_global(@GLOBAL_TXN_DATA_LEN)
    %stack (n, msw) -> (msw, @CTX_CALLDATA_SIZE, n, msw)
    MSTORE_GENERAL
    // copy the public calldata words (SEG_GLOBAL, big-endian packed)
    // into the child's byte-granular CALLDATA segment
    DUP2
    %seg_of(@SEGMENT_CALLDATA)   // [dsw, msw, child, tvptr, retdest]
    %mload_global(@GLOBAL_TXN_DATA_LEN)
    PUSH 0                       // [i, n, dsw, msw, child, tvptr, retdest]
ec_cd_loop:
    DUP2
    DUP2
    EQ
    %jumpi(ec_cd_done)
    // byte i = BYTE(i & 31, GLOBAL[DATA_BASE + (i >> 5)])
    DUP1
    PUSH 5
    SHR                          // [i>>5, i, n, dsw, ...]
    PUSH @GLOBAL_TXN_DATA_BASE
    ADD
    PUSH @SEGMENT_GLOBAL
    MLOAD_GENERAL                // [word, i, n, dsw, ...]
    DUP2
    PUSH 31
    AND                          // [i&31, word, i, n, dsw, ...]
    BYTE                         // [byte, i, n, dsw, ...]
    %stack (b, i, n, dsw) -> (dsw, i, b, i, n, dsw)
    MSTORE_GENERAL               // [i, n, dsw, ...]
    PUSH 1
    ADD
    %jump(ec_cd_loop)
ec_cd_done:
    // stack: i, n, dsw, msw, child, tvptr, retdest
    %stack (i, n, dsw, msw, child, tvptr) -> (child, child)
    // per-frame exit metadata (round 5: uniform with sys_call frames):
    // PARENT_CTX stays 0 (fresh cell), PARENT_PC = ec_ret, CKPT = the
    // txn-level checkpoint set by execute_transfer
    %seg_of(@SEGMENT_CTX_META)   // [cmsw, child]
    %stack (cmsw) -> (cmsw, @CTX_PARENT_PC, ec_ret, cmsw)
    MSTORE_GENERAL
    // top frame gas limit = block limit - intrinsic gas (no per-txn
    // gas_limit field in the reduced txn format — module note)
    %mload_global(@GLOBAL_GASLIMIT)
    %mload_global(@GLOBAL_INTRINSIC_GAS)
    DUP1
    DUP3
    LT                           // [limit < intr, intr, limit, cmsw, child]
    %jumpi(panic)
    SWAP1
    SUB                          // [limit - intr, cmsw, child]
    %stack (gl, cmsw) -> (cmsw, @CTX_GASLIMIT, gl, cmsw)
    MSTORE_GENERAL
    %mload_global(@GLOBAL_JOURNAL_CKPT)
    %stack (ck, cmsw) -> (cmsw, @CTX_CKPT, ck)
    MSTORE_GENERAL
    PUSH 1
    %mstore_global(@GLOBAL_CALL_DEPTH)
    // stack: child, retdest
    SET_CONTEXT                  // -> child context, sp = 0 (fresh META_SP)
    PUSH 0
    EXIT_KERNEL                  // user mode, pc 0, gas 0
ec_ret:
    // contract_exit SET_CONTEXTed back to 0 and jumped here; the
    // parent's SP (and with it [retdest]) was hardware-restored.
    // A failed TOP frame fails the transaction (inner-frame failures
    // only surface as CALL returning 0).
    %mload_global(@GLOBAL_LAST_FRAME_GAS)
    %mload_global(@GLOBAL_GAS_USED)
    ADD
    %mstore_global(@GLOBAL_GAS_USED)
    %mload_global(@GLOBAL_FRAME_STATUS)
    %jumpi(ec_ret_ok)
    PUSH 1
    %mstore_global(@GLOBAL_TXN_FAILED)
ec_ret_ok:
    JUMP
ec_skip2:
    POP
ec_skip:
    POP
    JUMP

// contract_exit(status, trap): finish the CURRENT frame — accumulate
// the frame's gas, journal-revert to the frame's own checkpoint on
// failure, publish the status, and return to the parent context at its
// stored continuation (terminate.asm + journal/revert.asm; round 5:
// fully per-frame via CTX_META, so sys_call frames nest arbitrarily)
global contract_exit:
    SWAP1                        // [trap, status]
    PUSH 192
    SHR                          // [frame_gas, status]
    // per-frame gas limit (gas.asm design): overrunning the limit is an
    // exceptional halt — the frame FAILS and consumes its whole limit,
    // however it tried to exit (EVM out-of-gas semantics, checked at
    // frame exit; an execution that never halts stays unprovable)
    %push_ctx_meta(@CTX_GASLIMIT)
    DUP2
    GT                           // [frame_gas > limit, frame_gas, status]
    ISZERO
    %jumpi(ce_in_gas)
    POP
    POP                          // drop gas + claimed status
    %push_ctx_meta(@CTX_GASLIMIT)
    PUSH 0
    SWAP1                        // [limit, 0]
ce_in_gas:
    // stack: frame_gas, status — the parent absorbs this charge
    // (sc_ret / cc_ret add it to their trap; ec_ret to GAS_USED)
    %mstore_global(@GLOBAL_LAST_FRAME_GAS)
    // stack: status
    DUP1
    %mstore_global(@GLOBAL_FRAME_STATUS)
    %jumpi(ce_done)              // nonzero: success
    %push_ctx_meta(@CTX_CKPT)
    %mstore_global(@GLOBAL_JOURNAL_CKPT)
    PUSH ce_done
    %jump(revert_journal)
ce_done:
    %push_ctx_meta(@CTX_PARENT_PC)
    %mstore_global(@GLOBAL_EXEC_RET)
    %push_ctx_meta(@CTX_PARENT_CTX)
    SET_CONTEXT                  // parent stack hardware-restored
    %mload_global(@GLOBAL_EXEC_RET)
    JUMP

// a user fault inside a contract frame fails the frame (the ctx-0 path
// in core.asm fault_exception halts the block instead)
global contract_fault:
    PUSH 0
    %mstore_global(@GLOBAL_FRAME_STATUS)
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    // an exceptional halt consumes the frame's whole gas limit (EVM)
    %push_ctx_meta(@CTX_GASLIMIT)
    %mstore_global(@GLOBAL_LAST_FRAME_GAS)
    %push_ctx_meta(@CTX_CKPT)
    %mstore_global(@GLOBAL_JOURNAL_CKPT)
    PUSH cf_1
    %jump(revert_journal)
cf_1:
    %push_ctx_meta(@CTX_PARENT_PC)
    %mstore_global(@GLOBAL_EXEC_RET)
    %push_ctx_meta(@CTX_PARENT_CTX)
    SET_CONTEXT
    %mload_global(@GLOBAL_EXEC_RET)
    JUMP

// copy_returndata(offset, len, retdest): (ctx, SEG_BYTES, offset+i) ->
// (0, SEG_RETURNDATA, i); records the length
global copy_returndata:
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, offset, len, retdest]
    %stack (bsw, offset, len) -> (0, len, offset, bsw)
crd_loop:
    // stack: i, len, offset, bsw, retdest
    DUP2
    DUP2
    EQ
    %jumpi(crd_done)
    %stack (i, len, offset, bsw) -> (i, offset, bsw, i, len, offset, bsw)
    ADD
    SWAP1                        // [bsw, offset+i, i, len, offset, bsw]
    MLOAD_GENERAL                // [byte, i, len, offset, bsw]
    %stack (b, i) -> (@SEGMENT_RETURNDATA, i, b, i)
    MSTORE_GENERAL               // [i, len, offset, bsw]
    PUSH 1
    ADD
    %jump(crd_loop)
crd_done:
    %stack (i, len, offset, bsw) -> (len)
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    JUMP

// ------------------------------------------- contract-frame syscalls

// [..] -> [value]: read slot $slot of the current context's metadata
%macro push_ctx_meta(slot)
    GET_CONTEXT
    %seg_of(@SEGMENT_CTX_META)
    PUSH $slot
    SWAP1
    MLOAD_GENERAL
%endmacro

// EIP-214: any state-modifying op inside a STATICCALL frame is an
// exceptional halt of that frame (reference core/call.asm static checks)
%macro assert_not_static
    %push_ctx_meta(@CTX_STATIC)
    %jumpi(contract_fault)
%endmacro

global sys_return:
    // stack (top first): trap, offset, len
    DUP3
    DUP3
    ADD                          // [end, trap, offset, len]
    %charge_memory
    %stack (trap, offset, len) -> (offset, len, sys_ret_1, trap)
    %jump(copy_returndata)
sys_ret_1:
    // stack: trap
    PUSH 1
    %jump(contract_exit)

global sys_revert:
    // stack: trap, offset, len
    DUP3
    DUP3
    ADD
    %charge_memory
    %stack (trap, offset, len) -> (offset, len, sys_rev_1, trap)
    %jump(copy_returndata)
sys_rev_1:
    PUSH 0
    %jump(contract_exit)

global sys_sload:
    // stack: trap, slot — EIP-2929: warm 100, cold 2100 (access.asm)
    %push_ctx_meta(@CTX_ACCT_VPTR)
    DUP3
    DUP2
    %stack (vptr, slot) -> (vptr, slot, ssl_0)
    %jump(warm_slot)
ssl_0:
    // stack: warm, vptr, trap, slot
    %jumpi(ssl_w)
    SWAP1
    %charge_gas(2000)            // cold surcharge on top of the base 100
    SWAP1
ssl_w:
    // stack: vptr, trap, slot
    %stack (vptr, trap, slot) -> (vptr, slot, ssl_1, trap)
    %jump(storage_read)
ssl_1:
    // stack: value, trap
    SWAP1
    %charge_gas(100)
    EXIT_KERNEL

global sys_sstore:
    // stack (top first): trap, slot, value — EVM dynamics (reduced to
    // current-value, no original-value tracking; gas.asm note):
    //   same value            -> no-op, 100
    //   fresh slot, v != 0    -> @J_SABSENT journal, write, 20000
    //   fresh slot, v == 0    -> pure no-op, 100
    //   live slot,  v != 0    -> @J_STORAGE journal, write, 2900
    //   live slot,  v == 0    -> @J_STORAGE journal, DELETE the key
    //                            (EVM zero-store semantics), 2900,
    //                            +4800 refund (EIP-3529, @J_REFUND)
    %assert_not_static
    // EIP-2929: touching a cold slot costs +2100 whatever the dynamics
    %push_ctx_meta(@CTX_ACCT_VPTR)
    DUP3
    DUP2
    %stack (vptr, slot) -> (vptr, slot, sss_w)
    %jump(warm_slot)
sss_w:
    // stack: warm, vptr, trap, slot, value
    %jumpi(sss_w1)
    SWAP1
    %charge_gas(2100)
    SWAP1
sss_w1:
    // stack: vptr, trap, slot, value
    %stack (vptr, trap, slot) -> (vptr, slot, sss_0, vptr, trap, slot)
    %jump(storage_probe)
sss_0:
    // stack: sv, vptr, trap, slot, value
    DUP1
    ISZERO
    %jumpi(sss_absent)
    %trie_read                   // [old, vptr, trap, slot, value]
    DUP5
    DUP2
    EQ
    %jumpi(sss_same)
    %stack (old, vptr, trap, slot, value) -> (@J_STORAGE, vptr, slot, old, sss_2, vptr, trap, slot, value)
    %jump(journal_append)
sss_2:
    // stack: vptr, trap, slot, value
    DUP4
    ISZERO
    %jumpi(sss_clear)
    %stack (vptr, trap, slot, value) -> (vptr, slot, value, sss_3, trap)
    %jump(storage_write)
sss_3:
    // stack: trap
    %charge_gas(2900)
    EXIT_KERNEL
sss_same:
    // stack: old, vptr, trap, slot, value
    %stack (old, vptr, trap, slot, value) -> (trap)
    %charge_gas(100)
    EXIT_KERNEL
sss_clear:
    // stack: vptr, trap, slot, value
    %mload_global(@GLOBAL_REFUND)
    DUP1
    %stack (ra, rb) -> (@J_REFUND, ra, 0, 0, sss_c1, rb)
    %jump(journal_append)
sss_c1:
    // stack: old_refund, vptr, trap, slot, value
    PUSH 4800
    ADD
    %mstore_global(@GLOBAL_REFUND)
    %stack (vptr, trap, slot, value) -> (vptr, slot, sss_c2, trap)
    %jump(storage_delete)
sss_c2:
    // stack: trap
    %charge_gas(2900)
    EXIT_KERNEL
sss_absent:
    // stack: sv(0), vptr, trap, slot, value
    POP
    DUP4
    ISZERO
    %jumpi(sss_az)
    %stack (vptr, trap, slot, value) -> (@J_SABSENT, vptr, slot, 0, sss_a2, vptr, trap, slot, value)
    %jump(journal_append)
sss_a2:
    %stack (vptr, trap, slot, value) -> (vptr, slot, value, sss_a3, trap)
    %jump(storage_write)
sss_a3:
    // stack: trap
    %charge_gas(20000)
    EXIT_KERNEL
sss_az:
    // storing 0 into an absent slot: a pure no-op
    %stack (vptr, trap, slot, value) -> (trap)
    %charge_gas(100)
    EXIT_KERNEL

global sys_calldataload:
    // stack: trap, i — 32-byte big-endian read of calldata bytes
    // i..i+32 (reads past the length are fresh and therefore 0, the
    // EVM zero-pad semantics via the memory AIR's fresh-read rule)
    GET_CONTEXT
    %seg_of(@SEGMENT_CALLDATA)   // [dsw, trap, i]
    %stack (dsw, trap, i) -> (0, 32, i, dsw, 0, trap)
scd_loop:
    // stack: j, 32, i, dsw, acc, trap
    DUP2
    DUP2
    EQ
    %jumpi(scd_done)
    %stack (j, n32, i, dsw, acc) -> (j, i, dsw, 8, acc, j, n32, i, dsw)
    ADD
    SWAP1                        // [dsw, i+j, 8, acc, j, n32, i, dsw]
    MLOAD_GENERAL                // [b, 8, acc, j, n32, i, dsw]
    SWAP2                        // [acc, 8, b, j, n32, i, dsw]
    SWAP1                        // [8, acc, b, ...]
    SHL                          // [acc<<8, b, ...]
    ADD                          // [acc', j, n32, i, dsw]
    %stack (acc, j, n32, i, dsw) -> (j, 1, n32, i, dsw, acc)
    ADD                          // [j+1, n32, i, dsw, acc]
    %jump(scd_loop)
scd_done:
    // stack: j, n32, i, dsw, acc, trap
    %stack (j, n32, i, dsw, acc) -> (acc)
    SWAP1
    %charge_gas(3)
    EXIT_KERNEL

global sys_calldatasize:
    // stack: trap
    %push_ctx_meta(@CTX_CALLDATA_SIZE)
    SWAP1
    %charge_gas(2)
    EXIT_KERNEL

global sys_caller:
    %push_ctx_meta(@CTX_CALLER)
    SWAP1
    %charge_gas(2)
    EXIT_KERNEL

global sys_callvalue:
    %push_ctx_meta(@CTX_CALLVALUE)
    SWAP1
    %charge_gas(2)
    EXIT_KERNEL

global sys_address:
    %push_ctx_meta(@CTX_ADDRESS)
    SWAP1
    %charge_gas(2)
    EXIT_KERNEL

// ------------------------------------------- inner message calls (CALL)

// sys_call: contract -> contract message call (reduced twin of
// reference core/call.asm).  CALL(gas, addr, value, argsOff, argsSize,
// retOff, retSize) -> success.  The gas word is ignored (flat-gas
// reduction — no 63/64 forwarding); args/ret address the byte-granular
// SEGMENT_BYTES memory (the same memory RETURN/REVERT/KECCAK256 use).
// Fail paths (depth cap, insufficient balance) push 0 without state
// changes, exactly the EVM result; a reverting child undoes its own
// journal (contract_exit) and the CALL pushes 0.
global sys_delegatecall:
    // stack: trap, gas, addr, ao, asz, ro, rs —
    // DELEGATECALL(gas, addr, argsOff, argsSize, retOff, retSize)
    // (reference core/call.asm sys_delegatecall): run addr's CODE under
    // the CALLER frame's identity — storage, ADDRESS, CALLER and
    // CALLVALUE all inherited; no value operand, no value transfer.  A
    // zero value is synthesized so the shared sys_call tail sees the
    // uniform 8-word shape.
    PUSH 1
    %mstore_global(@GLOBAL_CALL_KIND)
    %stack (trap, gas, addr) -> (trap, gas, addr, 0)
    %jump(sc_entry)

global sys_callcode:
    // stack: trap, gas, addr, value, ao, asz, ro, rs —
    // CALLCODE(gas, addr, value, ...) (reference core/call.asm
    // sys_callcode, deprecated-but-present): run addr's CODE against
    // the CALLER's storage and address (like DELEGATECALL) but with a
    // fresh CALLER/CALLVALUE from the operands (like CALL).  The value
    // "transfer" is self-to-self — no balance moves, but the EVM still
    // requires bal >= value (checked at sc_noxfer).  EIP-214 permits
    // value-bearing CALLCODE inside static frames (nothing moves).
    PUSH 3
    %mstore_global(@GLOBAL_CALL_KIND)
    %jump(sc_entry)

global sys_staticcall:
    // stack: trap, gas, addr, ao, asz, ro, rs —
    // STATICCALL(gas, addr, argsOff, argsSize, retOff, retSize)
    // (reference core/call.asm sys_staticcall): a valueless CALL whose
    // child frame — and every frame below it, via CTX_STATIC
    // inheritance — faults on any state-modifying op (EIP-214).
    PUSH 2
    %mstore_global(@GLOBAL_CALL_KIND)
    %stack (trap, gas, addr) -> (trap, gas, addr, 0)
    %jump(sc_entry)

global sys_call:
    // stack: trap, gas, addr, value, argsOff, argsSize, retOff, retSize
    PUSH 0
    %mstore_global(@GLOBAL_CALL_KIND)
    // EIP-214: a static frame may not transfer value — frame fault
    DUP4
    ISZERO
    %jumpi(sc_entry)
    %push_ctx_meta(@CTX_STATIC)
    %jumpi(contract_fault)
sc_entry:
    // stack: trap, gas, addr, value, ao, asz, ro, rs
    // memory windows [ao, ao+asz) and [ro, ro+rs) (charged upfront)
    DUP6
    DUP6
    ADD                          // [ao+asz, trap, gas, addr, value, ao, asz, ro, rs]
    %charge_memory
    DUP8
    DUP8
    ADD                          // [ro+rs, trap, ...]
    %charge_memory
    // EIP-2929: first touch of the callee address this txn costs
    // +2500 (2600 total with the base 100); precompiles/origin/to are
    // prewarmed (access_lists_init)
    DUP3
    %stack (a) -> (a, sc_acc)
    %jump(warm_addr)
sc_acc:
    // stack: warm, trap, gas, addr, value, ao, asz, ro, rs
    %jumpi(sc_acc_w)
    %charge_gas(2500)
sc_acc_w:
    // 63/64 rule: the child limit is min(gas operand, remaining -
    // remaining/64), remaining = frame limit - gas used so far
    // (core/call_gas.asm); +2300 stipend on value-bearing calls
    %push_ctx_meta(@CTX_GASLIMIT)
    DUP2
    PUSH 192
    SHR                          // [used, limit, trap, gas, ...]
    DUP2
    DUP2
    GT                           // [used > limit, used, limit, trap, gas, ...]
    %jumpi(sc_gas0)
    SWAP1
    SUB                          // [rem, trap, gas, ...]
    DUP1
    PUSH 64
    SWAP1
    DIV                          // [rem/64, rem, trap, gas, ...]
    SWAP1
    SUB                          // [cap = rem - rem/64, trap, gas, ...]
    DUP3
    DUP2
    GT                           // [cap > gas, cap, trap, gas, ...]
    ISZERO
    %jumpi(sc_cap_done)
    POP
    DUP2                         // cap = gas operand
    %jump(sc_cap_done)
sc_gas0:
    // stack: used, limit, trap, gas, ...
    POP
    POP
    PUSH 0                       // [cap = 0, trap, gas, ...]
sc_cap_done:
    // stack: cap, trap, gas, addr, value, ao, asz, ro, rs
    DUP5
    ISZERO
    %jumpi(sc_nostip)
    PUSH 2300
    ADD                          // value-bearing: callee stipend
sc_nostip:
    %mstore_global(@GLOBAL_CALL_GASCAP)
    // stack: trap, gas, addr, value, ao, asz, ro, rs
    // value-transfer surcharge (EVM G_callvalue = 9000)
    DUP4
    ISZERO
    %jumpi(sc_noval)
    %charge_gas(9000)
sc_noval:
    SWAP1
    POP                          // [trap, addr, value, ao, asz, ro, rs]
    // depth cap (EVM 1024)
    %mload_global(@GLOBAL_CALL_DEPTH)
    PUSH 1024
    EQ
    %jumpi(sc_fail)
    // DELEGATECALL/STATICCALL carry no value: skip the transfer block
    %mload_global(@GLOBAL_CALL_KIND)
    %jumpi(sc_noxfer)
    // caller must afford the value: bal(executing account) >= value
    %push_ctx_meta(@CTX_ACCT_VPTR)
    PUSH 1
    ADD
    %trie_read                   // [bal, trap, addr, value, ao, asz, ro, rs]
    DUP4
    SWAP1
    LT                           // [bal < value, trap, ...]
    %jumpi(sc_fail)
    // journaled debit of the caller's account
    %push_ctx_meta(@CTX_ACCT_VPTR)
    DUP1
    %journal_balance             // [vptr, trap, addr, value, ...]
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [bal, vptr, trap, addr, value, ...]
    DUP5
    SWAP1
    SUB                          // [bal - value, vptr, trap, ...]
    SWAP1
    PUSH 1
    ADD
    %trie_write                  // [trap, addr, value, ao, asz, ro, rs]
    // callee account (created fresh when absent and journaled so a
    // surrounding revert deletes it again — mpt_delete)
    DUP2
    %stack (a) -> (a, sc_k1)
    %jump(addr_key)
sc_k1:
    // stack: key, trap, addr, value, ao, asz, ro, rs
    DUP1
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, sc_k2)
    %jump(mpt_read)
sc_k2:
    // stack: cvptr, key, trap, addr, value, ao, asz, ro, rs
    DUP1
    ISZERO
    %jumpi(sc_create)
    // existing callee: journaled credit
    DUP1
    %journal_balance
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [cbal, cvptr, key, trap, addr, value, ...]
    DUP6
    ADD                          // [cbal + value, cvptr, key, ...]
    DUP2
    PUSH 1
    ADD                          // [cvptr+1, cbal+value, cvptr, key, ...]
    %trie_write                  // [cvptr, key, trap, addr, value, ...]
    %jump(sc_have)
sc_create:
    // stack: cvptr(0), key, trap, addr, value, ao, asz, ro, rs
    // EIP-158: a zero-value call to an absent account creates nothing
    // (essential for precompile addresses, which are usually empty)
    DUP5
    ISZERO
    %jumpi(sc_have)
    POP
    DUP1
    %stack (k) -> (@J_CREATE, k, 0, 0, sc_cr1)
    %jump(journal_append)
sc_cr1:
    // stack: key, trap, addr, value, ao, asz, ro, rs
    SWAP1
    %charge_gas(25000)           // EVM G_newaccount
    SWAP1
    DUP1
    DUP5
    SWAP1                        // [key, value, key, trap, ...]
    %stack (k, v) -> (k, v, sc_cr2)
    %jump(credit_account)
sc_cr2:
    // stack: key, trap, addr, value, ao, asz, ro, rs — re-read the vptr
    DUP1
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, sc_have)
    %jump(mpt_read)
sc_noxfer:
    // stack: trap, addr, value, ao, asz, ro, rs — no value transfer;
    // just resolve the callee account (for its code hash; STATICCALL
    // also reads its storage through cvptr)
    %mload_global(@GLOBAL_CALL_KIND)
    PUSH 3
    EQ
    ISZERO
    %jumpi(sc_nx0)
    // CALLCODE: the self-transfer still requires bal >= value
    %push_ctx_meta(@CTX_ACCT_VPTR)
    PUSH 1
    ADD
    %trie_read                   // [bal, trap, addr, value, ao, asz, ro, rs]
    DUP4
    SWAP1
    LT                           // [bal < value, trap, ...]
    %jumpi(sc_fail)
sc_nx0:
    DUP2
    %stack (a) -> (a, sc_nx1)
    %jump(addr_key)
sc_nx1:
    // stack: key, trap, addr, value, ao, asz, ro, rs
    DUP1
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, sc_have)
    %jump(mpt_read)
sc_have:
    // stack: cvptr, key, trap, addr, value, ao, asz, ro, rs
    SWAP1
    POP                          // [cvptr, trap, addr, value, ao, asz, ro, rs]
    // precompiled contracts: addresses 1..9 run in-kernel
    // (precompiles.asm) after the value transfer, no child frame
    DUP3
    PUSH 10
    SWAP1
    LT                           // [addr < 10, cvptr, trap, addr, ...]
    DUP4
    ISZERO
    ISZERO                       // [addr != 0, addr < 10, cvptr, ...]
    AND
    %jumpi(sc_precompile)
    // absent callee (zero-value skip-create): plain success, no frame
    DUP1
    ISZERO
    %jumpi(sc_no_acct)
    DUP1
    PUSH 3
    ADD
    %trie_read                   // [chash, cvptr, trap, ...]
    DUP1
    PUSH @EMPTY_CODE_HASH
    EQ
    %jumpi(sc_nocode)
    // codeful callee: fresh child frame
    %mload_global(@GLOBAL_NEXT_CTX)
    PUSH 1
    ADD
    DUP1
    %mstore_global(@GLOBAL_NEXT_CTX)
    %stack (child, chash, cvptr) -> (chash, child, sc_code, child, cvptr)
    %jump(load_contract_code)
sc_code:
    // stack: child, cvptr, trap, addr, value, ao, asz, ro, rs
    %mload_global(@GLOBAL_CALL_KIND)
    DUP1
    PUSH 1
    EQ
    SWAP1
    PUSH 3
    EQ
    OR
    ISZERO
    %jumpi(sc_code_k)
    // DELEGATECALL/CALLCODE: the child keeps the caller frame's account
    // (storage writes land in the CALLER's storage) and address — only
    // the CODE came from `addr` (load_contract_code above)
    %push_ctx_meta(@CTX_ACCT_VPTR)
    SWAP2
    POP                          // cvptr := caller frame's vptr
    %push_ctx_meta(@CTX_ADDRESS)
    SWAP4
    POP                          // addr := caller frame's address
    %mload_global(@GLOBAL_CALL_KIND)
    PUSH 1
    EQ
    ISZERO
    %jumpi(sc_code_k)
    // DELEGATECALL only: call value and original caller also inherit
    %push_ctx_meta(@CTX_CALLVALUE)
    SWAP5
    POP                          // value := caller frame's callvalue
sc_code_k:
    %mload_global(@GLOBAL_CALL_DEPTH)
    PUSH 1
    ADD
    %mstore_global(@GLOBAL_CALL_DEPTH)
    DUP1
    %seg_of(@SEGMENT_CTX_META)   // [cmsw, child, cvptr, trap, addr, value, ao, asz, ro, rs]
    %stack (cmsw, child, cvptr) -> (cmsw, @CTX_ACCT_VPTR, cvptr, cmsw, child)
    MSTORE_GENERAL               // [cmsw, child, trap, addr, value, ao, asz, ro, rs]
    DUP4
    %stack (a, cmsw) -> (cmsw, @CTX_ADDRESS, a, cmsw)
    MSTORE_GENERAL
    %mload_global(@GLOBAL_CALL_KIND)
    PUSH 1
    EQ
    %jumpi(sc_clr_dg)
    %push_ctx_meta(@CTX_ADDRESS) // caller frame's own address
    %jump(sc_clr_go)
sc_clr_dg:
    %push_ctx_meta(@CTX_CALLER)  // DELEGATECALL: original caller persists
sc_clr_go:
    %stack (m, cmsw) -> (cmsw, @CTX_CALLER, m, cmsw)
    MSTORE_GENERAL
    DUP5
    %stack (v, cmsw) -> (cmsw, @CTX_CALLVALUE, v, cmsw)
    MSTORE_GENERAL
    // static-ness: inherited from the caller frame, or set by STATICCALL
    %push_ctx_meta(@CTX_STATIC)
    %mload_global(@GLOBAL_CALL_KIND)
    PUSH 2
    EQ
    ADD
    ISZERO
    ISZERO                       // normalize (inherited + set) to 0/1
    %stack (s, cmsw) -> (cmsw, @CTX_STATIC, s, cmsw)
    MSTORE_GENERAL
    DUP7
    %stack (n, cmsw) -> (cmsw, @CTX_CALLDATA_SIZE, n, cmsw)
    MSTORE_GENERAL
    GET_CONTEXT
    %stack (p, cmsw) -> (cmsw, @CTX_PARENT_CTX, p, cmsw)
    MSTORE_GENERAL
    %stack (cmsw) -> (cmsw, @CTX_PARENT_PC, sc_ret, cmsw)
    MSTORE_GENERAL
    %mload_global(@GLOBAL_CALL_GASCAP)
    %stack (gl, cmsw) -> (cmsw, @CTX_GASLIMIT, gl, cmsw)
    MSTORE_GENERAL
    // frame checkpoint = journal length BEFORE this CALL's own debit +
    // credit/create entries (always exactly 2), so a child revert also
    // undoes the value transfer; DELEGATECALL/STATICCALL journal nothing
    %mload_global(@GLOBAL_JOURNAL_LEN)
    %mload_global(@GLOBAL_CALL_KIND)
    %jumpi(sc_ckpt_nx)
    PUSH 2
    SWAP1
    SUB
sc_ckpt_nx:
    %stack (ck, cmsw) -> (cmsw, @CTX_CKPT, ck)
    MSTORE_GENERAL               // [child, trap, addr, value, ao, asz, ro, rs]
    // copy calldata: caller BYTES[ao .. ao+asz) -> child CALLDATA[0..)
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [srcsw, child, trap, addr, value, ao, asz, ro, rs]
    DUP2
    %seg_of(@SEGMENT_CALLDATA)   // [dstsw, srcsw, child, trap, addr, value, ao, asz, ro, rs]
    PUSH 0
sc_cd_loop:
    // stack: i, dstsw, srcsw, child, trap, addr, value, ao, asz, ro, rs
    DUP9
    DUP2
    EQ
    %jumpi(sc_cd_done)
    DUP1
    DUP9
    ADD                          // [ao+i, i, dstsw, srcsw, ...]
    DUP4
    SWAP1                        // [ao+i, srcsw, i, dstsw, srcsw, ...]
    SWAP1                        // [srcsw, ao+i, i, dstsw, srcsw, ...]
    MLOAD_GENERAL                // [b, i, dstsw, srcsw, child, ...]
    %stack (b, i, dstsw) -> (dstsw, i, b, i, dstsw)
    MSTORE_GENERAL               // [i, dstsw, srcsw, child, ...]
    PUSH 1
    ADD
    %jump(sc_cd_loop)
sc_cd_done:
    // stack: i, dstsw, srcsw, child, trap, addr, value, ao, asz, ro, rs
    %stack (i, dstsw, srcsw, child, trap, addr, value, ao, asz, ro, rs) -> (child, trap, ro, rs)
    SET_CONTEXT                  // saves the caller stack [trap, ro, rs]
    PUSH 0
    EXIT_KERNEL                  // callee runs at pc 0, empty stack
sc_precompile:
    // stack: cvptr, trap, addr, value, ao, asz, ro, rs
    POP
    SWAP1                        // [addr, trap, value, ao, asz, ro, rs]
    %jump(precompile_dispatch)
sc_ret:
    // child exited; ctx = caller (kernel mode), stack: trap, ro, rs
    %mload_global(@GLOBAL_CALL_DEPTH)
    PUSH 1
    SWAP1
    SUB
    %mstore_global(@GLOBAL_CALL_DEPTH)
    // the child's gas charge lands in the parent's own counter
    %mload_global(@GLOBAL_LAST_FRAME_GAS)
    PUSH 192
    SHL
    ADD                          // [trap', ro, rs]
global sc_ret_precompile:
    // n = min(rs, returndata_len)
    %mload_global(@GLOBAL_RETURNDATA_LEN)
    DUP4
    DUP2
    GT                           // [rdlen > rs, rdlen, trap, ro, rs]
    ISZERO
    %jumpi(sc_rd_n)
    POP
    DUP3                         // n = rs
sc_rd_n:
    // stack: n, trap, ro, rs
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, n, trap, ro, rs]
    PUSH 0
sc_rd_loop:
    // stack: i, bsw, n, trap, ro, rs
    DUP3
    DUP2
    EQ
    %jumpi(sc_rd_done)
    DUP1
    PUSH @SEGMENT_RETURNDATA
    MLOAD_GENERAL                // [b, i, bsw, n, trap, ro, rs]
    DUP2
    DUP7
    ADD                          // [ro+i, b, i, bsw, n, trap, ro, rs]
    DUP4
    SWAP1                        // [ro+i, bsw, b, i, bsw, ...]
    SWAP1                        // [bsw, ro+i, b, i, bsw, n, trap, ro, rs]
    MSTORE_GENERAL               // [i, bsw, n, trap, ro, rs]
    PUSH 1
    ADD
    %jump(sc_rd_loop)
sc_rd_done:
    // stack: i, bsw, n, trap, ro, rs
    %stack (i, bsw, n) -> ()
    %mload_global(@GLOBAL_FRAME_STATUS)
    %stack (status, trap, ro, rs) -> (trap, status)
    %charge_gas(100)
    EXIT_KERNEL
sc_no_acct:
    // stack: cvptr(0), trap, addr, value, ao, asz, ro, rs
    PUSH 0                       // shape-match sc_nocode's [chash, cvptr]
sc_nocode:
    // plain value transfer: success, empty returndata
    // stack: chash, cvptr, trap, addr, value, ao, asz, ro, rs
    POP
    POP
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %stack (trap, addr, value, ao, asz, ro, rs) -> (trap, 1)
    %charge_gas(100)
    EXIT_KERNEL
sc_fail:
    // stack: trap, addr, value, ao, asz, ro, rs
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %stack (trap, addr, value, ao, asz, ro, rs) -> (trap, 0)
    %charge_gas(100)
    EXIT_KERNEL

global sys_returndatasize:
    %mload_global(@GLOBAL_RETURNDATA_LEN)
    SWAP1
    %charge_gas(2)
    EXIT_KERNEL

global sys_returndatacopy:
    // stack: trap, destOff, off, len — (0, RETURNDATA)[off+i] ->
    // BYTES[destOff+i]; reads past returndata are fresh zeros
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, trap, destOff, off, len]
    PUSH 0
src_rdc_loop:
    // stack: i, bsw, trap, destOff, off, len
    DUP6
    DUP2
    EQ
    %jumpi(src_rdc_done)
    DUP1
    DUP6
    ADD                          // [off+i, i, bsw, trap, destOff, off, len]
    PUSH @SEGMENT_RETURNDATA
    MLOAD_GENERAL                // [b, i, bsw, trap, destOff, off, len]
    DUP2
    DUP6
    ADD                          // [destOff+i, b, i, bsw, ...]
    DUP4
    SWAP1                        // [destOff+i, bsw, b, ...]
    SWAP1                        // [bsw, destOff+i, b, i, bsw, trap, destOff, off, len]
    MSTORE_GENERAL               // [i, bsw, trap, destOff, off, len]
    PUSH 1
    ADD
    %jump(src_rdc_loop)
src_rdc_done:
    %stack (i, bsw, trap, destOff, off, len) -> (trap)
    %charge_gas(3)
    EXIT_KERNEL

// SELFDESTRUCT (0xff): EIP-6780 reduced — sweep the executing
// account's balance to the beneficiary and halt the frame with
// success; the account itself always survives (the reference deletes
// same-transaction creations; documented reduction: never deleted).
global sys_selfdestruct:
    // stack (top first): trap, beneficiary
    GET_CONTEXT
    ISZERO
    %jumpi(panic)                // only meaningful inside a frame
    %assert_not_static
    // EIP-2929: a cold beneficiary costs +2600
    DUP2
    %stack (a) -> (a, sd_acc)
    %jump(warm_addr)
sd_acc:
    // stack: warm, trap, beneficiary
    %jumpi(sd_acc_w)
    %charge_gas(2600)
sd_acc_w:
    %push_ctx_meta(@CTX_ACCT_VPTR)
    DUP1
    %journal_balance
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [bal, vptr, trap, beneficiary]
    SWAP1
    PUSH 1
    ADD
    PUSH 0
    SWAP1
    %trie_write                  // own balance = 0 ; [bal, trap, b]
    DUP3
    %stack (b) -> (b, sd_1)
    %jump(addr_key)
sd_1:
    // stack: key, bal, trap, beneficiary
    DUP1
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, sd_2)
    %jump(mpt_read)
sd_2:
    // stack: bvptr, key, bal, trap, beneficiary
    DUP1
    ISZERO
    %jumpi(sd_fresh)
    DUP1
    %journal_balance
    DUP1
    PUSH 1
    ADD
    %trie_read                   // [bbal, bvptr, key, bal, trap, b]
    DUP4
    ADD
    SWAP1
    PUSH 1
    ADD
    %trie_write                  // [key, bal, trap, beneficiary]
    %jump(sd_done)
sd_fresh:
    // stack: bvptr(0), key, bal, trap, beneficiary — create only for a
    // nonzero sweep (EIP-158)
    POP
    DUP2
    ISZERO
    %jumpi(sd_done)
    DUP1
    %stack (k) -> (@J_CREATE, k, 0, 0, sd_f1)
    %jump(journal_append)
sd_f1:
    // stack: key, bal, trap, beneficiary
    DUP1
    DUP3
    SWAP1                        // [key, bal, key, bal, trap, b]
    %stack (k, v) -> (k, v, sd_done)
    %jump(credit_account)
sd_done:
    // stack: key, bal, trap, beneficiary
    %stack (key, bal, trap, beneficiary) -> (trap)
    %charge_gas(5000)
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    PUSH 1
    %jump(contract_exit)
