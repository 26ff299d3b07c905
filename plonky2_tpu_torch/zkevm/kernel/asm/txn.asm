// Transaction processing: a native balance transfer through the state
// trie, with txn/receipt trie insertion and before/after root checks
// (reduced twin of reference cpu/kernel/asm/core/{process_txn.asm,
// transactions/*}.asm + evm/tests/simple_transfer.rs semantics).
//
// Round-2 reduction (documented in kernel/aggregator.py): signature
// checking is out of scope — the txn fields (sender, to, value, nonce,
// gas_price) are public inputs in SEG_GLOBAL, bound to the proof via
// the program-ROM commitment.  Gas charged is the intrinsic 21000.
// Stack comments list the TOP first.

// addr_key(addr, retdest) -> packed: the 64-nibble state-trie key
// keccak(address) as a big-endian packed word (mpt.py state_key).
global addr_key:
    // stack: addr, retdest
    PUSH 20
    %rlp_alloc                   // [a, addr, retdest]
    %stack (a, addr) -> (a, addr, 20, ak_1, a)
    %jump(mstore_be)
ak_1:
    // stack: a, retdest
    %stack (a) -> (@SEGMENT_RLP, a, 20)
    KECCAK_GENERAL               // [digest_le, retdest]
    %stack (d) -> (d, ak_2)
    %jump(byteswap32)
ak_2:
    // stack: digest_be (= packed 64-nibble key), retdest
    SWAP1
    JUMP

// credit_account(key, amount, retdest): balance += amount, creating a
// fresh account (nonce 0, empty storage, empty code) if absent.
global credit_account:
    // stack: key, amount, retdest
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, key) -> (state, 64, key, ca_read, key)
    %jump(mpt_read)
ca_read:
    // stack: vptr, key, amount, retdest
    DUP1
    ISZERO
    %jumpi(ca_create)
    %stack (vptr, key, amount) -> (vptr, 1, amount, vptr, 1)
    ADD                          // [vptr+1, amount, vptr, 1]
    %trie_read                   // [bal, amount, vptr, 1]
    ADD                          // [bal+amount, vptr, 1]
    %stack (nb, vptr, one) -> (vptr, one, nb)
    ADD                          // [vptr+1, nb]
    %trie_write                  // [retdest]
    JUMP
ca_create:
    // stack: vptr(0), key, amount, retdest
    POP
    PUSH 1
    %trie_alloc                  // [sp_, key, amount] — fresh cell 0 = EMPTY node
    PUSH 4
    %trie_alloc                  // [vptr, sp_, key, amount] — nonce cell already 0
    %stack (vptr, sp_, key, amount) -> (vptr, 1, amount, vptr, 2, sp_, vptr, 3, vptr, key)
    ADD
    %trie_write                  // TRIE[vptr+1] = amount
    ADD
    %trie_write                  // TRIE[vptr+2] = empty storage node
    ADD                          // [vptr+3, vptr, key]
    PUSH @EMPTY_CODE_HASH
    SWAP1
    %trie_write                  // TRIE[vptr+3] = keccak("")
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, vptr, key) -> (state, 64, key, vptr, ca_created)
    %jump(mpt_insert)
ca_created:
    // stack: newstate, retdest
    %mstore_global(@GLOBAL_STATE_TRIE_PTR)
    JUMP

// rlp_to_trie_bytes(addr, len, retdest) -> vptr: copy RLP[addr..addr+len)
// into a fresh TRIE bytes-value [len, b0..b_{len-1}].
global rlp_to_trie_bytes:
    // stack: addr, len, retdest
    DUP2
    PUSH 1
    ADD
    %trie_alloc                  // [vptr, addr, len]
    DUP3
    DUP2
    %trie_write                  // TRIE[vptr] = len
    PUSH 0                       // i
rtb_loop:
    // stack: i, vptr, addr, len, retdest
    DUP4
    DUP2
    EQ
    %jumpi(rtb_done)
    %stack (i, vptr, addr) -> (addr, i, vptr, 1, i, i, vptr, addr)
    ADD                          // [addr+i, vptr, 1, i, i, vptr, addr]
    %rlp_read                    // [b, vptr, 1, i, i, vptr, addr]
    %stack (b, vptr, one, i) -> (vptr, one, i, b)
    ADD
    ADD                          // [vptr+1+i, b, i, vptr, addr, len]
    %trie_write                  // [i, vptr, addr, len]
    PUSH 1
    ADD
    %jump(rtb_loop)
rtb_done:
    %stack (i, vptr, addr, len, retdest) -> (retdest, vptr)
    JUMP

// build_txn_value(retdest) -> vptr: TRIE bytes-value holding the txn
// RLP rlp([nonce, gas_price, 21000, to, value, data]) (legacy-txn
// reduction; data = the public calldata words in SEG_GLOBAL).
global build_txn_value:
    PUSH 12
    %trie_alloc                  // [scratch, retdest]
    %mload_global(@GLOBAL_TXN_NONCE)
    %stack (nonce, scratch) -> (nonce, btv_1, scratch)
    %jump(rlp_scalar)
btv_1:
    // stack: a, l, scratch, retdest
    %stack (a, l, scratch) -> (scratch, a, scratch, 1, l, scratch)
    %trie_write
    ADD
    %trie_write                  // [scratch]
    %mload_global(@GLOBAL_TXN_GASPRICE)
    %stack (gp, scratch) -> (gp, btv_2, scratch)
    %jump(rlp_scalar)
btv_2:
    %stack (a, l, scratch) -> (scratch, 2, a, scratch, 3, l, scratch)
    ADD
    %trie_write
    ADD
    %trie_write
    PUSH 21000
    %stack (g, scratch) -> (g, btv_3, scratch)
    %jump(rlp_scalar)
btv_3:
    %stack (a, l, scratch) -> (scratch, 4, a, scratch, 5, l, scratch)
    ADD
    %trie_write
    ADD
    %trie_write
    // to-address item: 0x94 || 20 address bytes
    PUSH 21
    %rlp_alloc                   // [a, scratch]
    DUP1
    PUSH 0x94
    SWAP1
    %rlp_write                   // [a, scratch]
    %mload_global(@GLOBAL_TXN_TO)
    DUP2
    PUSH 1
    ADD                          // [a+1, to, a, scratch]
    %stack (a1, to) -> (a1, to, 20, btv_4)
    %jump(mstore_be)
btv_4:
    // stack: a, scratch, retdest
    %stack (a, scratch) -> (scratch, 6, a, scratch, 7, 21, scratch)
    ADD
    %trie_write
    ADD
    %trie_write
    %mload_global(@GLOBAL_TXN_VALUE)
    %stack (v, scratch) -> (v, btv_5, scratch)
    %jump(rlp_scalar)
btv_5:
    %stack (a, l, scratch) -> (scratch, 8, a, scratch, 9, l, scratch)
    ADD
    %trie_write
    ADD
    %trie_write                  // [scratch, retdest]
    // data item: the calldata bytes (big-endian packed SEG_GLOBAL words)
    %mload_global(@GLOBAL_TXN_DATA_LEN)
    DUP1
    %rlp_alloc                   // [da, n, scratch, retdest]
    PUSH 0                       // [i, da, n, scratch]
btv_d_loop:
    DUP3
    DUP2
    EQ
    %jumpi(btv_d_done)
    // byte i = BYTE(i & 31, GLOBAL[DATA_BASE + (i >> 5)])
    DUP1
    PUSH 5
    SHR
    PUSH @GLOBAL_TXN_DATA_BASE
    ADD
    PUSH @SEGMENT_GLOBAL
    MLOAD_GENERAL                // [word, i, da, n, scratch]
    DUP2
    PUSH 31
    AND
    BYTE                         // [b, i, da, n, scratch]
    %stack (b, i, da) -> (i, da, b, i, da)
    ADD                          // [da+i, b, i, da]
    %rlp_write                   // [i, da, n, scratch]
    PUSH 1
    ADD
    %jump(btv_d_loop)
btv_d_done:
    // stack: i, da, n, scratch, retdest
    %stack (i, da, n) -> (da, n, btv_d1)
    %jump(rlp_wrap_string)
btv_d1:
    // stack: wa, wl, scratch, retdest
    %stack (wa, wl, scratch) -> (scratch, 10, wa, scratch, 11, wl, scratch)
    ADD
    %trie_write
    ADD
    %trie_write                  // [scratch, retdest]
    %stack (scratch) -> (scratch, 6, btv_6)
    %jump(cat_items)
btv_6:
    // stack: addr, len, retdest
    %jump(rlp_to_trie_bytes)

// build_receipt_value(retdest) -> vptr: the full legacy receipt
// payload rlp([status, cum_gas, bloom, logs]) (reference receipt
// encoding, mpt/hash + core/log.asm bloom) with
//   status  = 1 - @GLOBAL_TXN_FAILED,
//   cum_gas = intrinsic + frames' gas - capped refund (gas.asm),
//   bloom   = the 256-byte logs bloom (logs.asm build_log_bloom),
//   logs    = the surviving logs list (logs.asm encode_logs_rlp).
global build_receipt_value:
    PUSH 8
    %trie_alloc
    %mload_global(@GLOBAL_TXN_FAILED)
    PUSH 1
    SUB                          // [status = 1 - failed, scratch]
    %stack (st, scratch) -> (st, brv_1, scratch)
    %jump(rlp_scalar)
brv_1:
    %stack (a, l, scratch) -> (scratch, a, scratch, 1, l, scratch)
    %trie_write
    ADD
    %trie_write
    %mload_global(@GLOBAL_GAS_USED)
    %mload_global(@GLOBAL_INTRINSIC_GAS)
    ADD                          // [total, scratch]
    // EIP-3529: the SSTORE-clearing refund, capped at total/5
    %mload_global(@GLOBAL_REFUND)
    DUP2
    PUSH 5
    SWAP1
    DIV                          // [total/5, refund, total, scratch]
    DUP2
    DUP2
    GT                           // [total/5 > refund, total/5, refund, ..]
    %jumpi(brv_uncapped)
    SWAP1                        // refund exceeds the cap: use the cap
brv_uncapped:
    POP                          // [refund', total, scratch]
    SWAP1
    SUB                          // [gas = total - refund', scratch]
    %stack (g, scratch) -> (g, brv_2, scratch)
    %jump(rlp_scalar)
brv_2:
    %stack (a, l, scratch) -> (scratch, 2, a, scratch, 3, l, scratch)
    ADD
    %trie_write
    ADD
    %trie_write
    // the 2048-bit bloom as a 256-byte string item
    PUSH brv_3
    %jump(build_log_bloom)
brv_3:
    // stack: baddr, scratch, retdest
    %stack (baddr) -> (baddr, 256, brv_4)
    %jump(rlp_wrap_string)
brv_4:
    %stack (a, l, scratch) -> (scratch, 4, a, scratch, 5, l, scratch)
    ADD
    %trie_write
    ADD
    %trie_write
    // the logs list
    PUSH brv_5
    %jump(encode_logs_rlp)
brv_5:
    %stack (a, l, scratch) -> (scratch, 6, a, scratch, 7, l, scratch)
    ADD
    %trie_write
    ADD
    %trie_write
    %stack (scratch) -> (scratch, 4, brv_6)
    %jump(cat_items)
brv_6:
    %jump(rlp_to_trie_bytes)

// execute_transfer(retdest): debit sender (nonce check, balance check,
// nonce += 1), credit recipient + beneficiary, insert txn and receipt
// into their tries at key rlp(0) = 0x80.
global execute_transfer:
    // EIP-2929 warm sets start fresh each txn, prewarmed with origin,
    // recipient and the precompile addresses (access.asm)
    PUSH et_al
    %jump(access_lists_init)
et_al:
    // intrinsic gas: 21000 + calldata bytes (gas.asm, EIP-2028); the
    // fee charged upfront is gasprice * intrinsic — executed frames'
    // gas reaches the RECEIPT but not the sender's balance (no per-txn
    // gas_limit field in the reduced txn format; documented)
    PUSH et_ig
    %jump(compute_intrinsic_gas)
et_ig:
    // sender authorization: recover from the signature and check the
    // claimed sender (curve.asm; skipped when SIG_R = 0 — unsigned mode)
    PUSH et_0
    %jump(verify_txn_signature)
et_0:
    %mload_global(@GLOBAL_TXN_SENDER)
    %stack (saddr) -> (saddr, et_1)
    %jump(addr_key)
et_1:
    // stack: skey, retdest
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, skey) -> (state, 64, skey, et_2)
    %jump(mpt_read)
et_2:
    // stack: svptr, retdest
    DUP1
    ISZERO
    %jumpi(panic)                // sender must exist
    DUP1
    %trie_read                   // [nonce, svptr]
    %mload_global(@GLOBAL_TXN_NONCE)
    EQ
    ISZERO
    %jumpi(panic)                // nonce mismatch
    // upfront balance check: bal >= fee + value (process_txn.asm
    // buy_gas + validation order)
    %mload_global(@GLOBAL_TXN_GASPRICE)
    %mload_global(@GLOBAL_INTRINSIC_GAS)
    MUL                          // [fee, svptr]
    %mload_global(@GLOBAL_TXN_VALUE)
    DUP2
    ADD                          // [cost, fee, svptr]
    DUP3
    PUSH 1
    ADD
    %trie_read                   // [bal, cost, fee, svptr]
    DUP2
    DUP2
    LT                           // bal < cost ?
    %jumpi(panic)
    // debit the fee + bump the nonce — these PERSIST even when the
    // contract frame reverts (EVM: gas is paid, the nonce advances)
    %stack (bal, cost, fee, svptr) -> (bal, fee, svptr, svptr)
    SUB                          // [bal-fee, svptr, svptr]
    DUP2
    PUSH 1
    ADD
    %trie_write                  // TRIE[svptr+1] = bal-fee ; [svptr, svptr]
    DUP1
    %trie_read                   // [nonce, svptr, svptr]
    PUSH 1
    ADD
    SWAP1
    %trie_write                  // TRIE[svptr] = nonce+1 ; [svptr, retdest]
    // checkpoint: everything journaled past here is undone by a
    // contract REVERT/fault (journal/journal.asm %checkpoint)
    %mload_global(@GLOBAL_JOURNAL_LEN)
    %mstore_global(@GLOBAL_JOURNAL_CKPT)
    // journaled value debit
    DUP1
    %journal_balance             // [svptr, retdest]
    %mload_global(@GLOBAL_TXN_VALUE)
    DUP2
    PUSH 1
    ADD
    %trie_read                   // [bal, value, svptr, retdest]
    SUB                          // [bal-value, svptr, retdest]
    DUP2
    PUSH 1
    ADD
    %trie_write                  // [svptr, retdest]
    POP
    // credit recipient with value (journaled when the account exists;
    // reverting a CREATED account would need mpt_delete — see
    // contract.asm journal note)
    %mload_global(@GLOBAL_TXN_TO)
    %stack (taddr) -> (taddr, et_3)
    %jump(addr_key)
et_3:
    // stack: tkey, retdest
    DUP1
    %mload_global(@GLOBAL_STATE_TRIE_PTR)
    %stack (state, tkey) -> (state, 64, tkey, et_3b)
    %jump(mpt_read)
et_3b:
    // stack: tvptr, tkey, retdest
    DUP1
    ISZERO
    %jumpi(et_3c)
    %journal_balance
    %jump(et_3d)
et_3c:
    // fresh recipient: journal the creation so a frame revert can
    // delete the account again (contract.asm rj_create / mpt_delete);
    // the beneficiary's later credit_account is deliberately NOT
    // journaled — the fee persists across reverts
    POP
    DUP1
    %stack (k) -> (@J_CREATE, k, 0, 0, et_3cj)
    %jump(journal_append)
et_3cj:
et_3d:
    // stack: tkey, retdest
    DUP1
    %mload_global(@GLOBAL_TXN_VALUE)
    %stack (value, tkey) -> (tkey, value, et_4)
    %jump(credit_account)
et_4:
    // stack: tkey, retdest — credit beneficiary with the fee
    %mload_global(@GLOBAL_BLOCK_BENEFICIARY)
    %stack (baddr) -> (baddr, et_5)
    %jump(addr_key)
et_5:
    // stack: bkey, tkey, retdest
    %mload_global(@GLOBAL_TXN_GASPRICE)
    %mload_global(@GLOBAL_INTRINSIC_GAS)
    MUL
    %stack (fee, bkey) -> (bkey, fee, et_6)
    %jump(credit_account)
et_6:
    // stack: tkey, retdest — run the recipient's code, if any
    %stack (tkey) -> (tkey, et_6b)
    %jump(execute_contract)
et_6b:
    // txn trie insert at key rlp(0) = 0x80 -> 2 nibbles (8, 0)
    PUSH et_7
    %jump(build_txn_value)
et_7:
    // stack: vptr, retdest
    %mload_global(@GLOBAL_TXN_TRIE_PTR)
    %stack (txnp, vptr) -> (txnp, 2, 0x80, vptr, et_8)
    %jump(mpt_insert)
et_8:
    %mstore_global(@GLOBAL_TXN_TRIE_PTR)
    PUSH et_9
    %jump(build_receipt_value)
et_9:
    %mload_global(@GLOBAL_RECEIPT_TRIE_PTR)
    %stack (rp, vptr) -> (rp, 2, 0x80, vptr, et_10)
    %jump(mpt_insert)
et_10:
    %mstore_global(@GLOBAL_RECEIPT_TRIE_PTR)
    JUMP

// ---- the transfer block's kernel main

%macro check_trie_root(hashfn, slot)
    PUSH %%bs
    %jump($hashfn)
%%bs:
    %stack (d) -> (d, %%ck)
    %jump(byteswap32)
%%ck:
    %stack (d) -> (d, $slot, %%done)
    %jump(check_root)
%%done:
%endmacro

// txn_main: load tries, check claimed before-roots, execute the
// transfer, check claimed after-roots, halt.  All six roots and the
// txn fields are public via the ROM-bound SEG_GLOBAL image.
global txn_main:
    PUSH tm_1
    %jump(load_all_tries)
tm_1:
    %check_trie_root(hash_state_trie, @GLOBAL_STATE_ROOT_BEFORE)
    %check_trie_root(hash_txn_trie, @GLOBAL_TXN_ROOT_BEFORE)
    %check_trie_root(hash_receipt_trie, @GLOBAL_RECEIPT_ROOT_BEFORE)
    // empty block (reference evm/tests/empty_txn_list.rs): no txn to
    // execute, the after-roots must equal the before-roots
    %mload_global(@GLOBAL_TXN_COUNT)
    ISZERO
    %jumpi(tm_2)
    PUSH tm_2
    %jump(execute_transfer)
tm_2:
    %check_trie_root(hash_state_trie, @GLOBAL_STATE_ROOT_AFTER)
    %check_trie_root(hash_txn_trie, @GLOBAL_TXN_ROOT_AFTER)
    %check_trie_root(hash_receipt_trie, @GLOBAL_RECEIPT_ROOT_AFTER)
    HALT
