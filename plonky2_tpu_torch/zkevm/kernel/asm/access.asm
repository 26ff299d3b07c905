// EIP-2929 access lists (twin of reference
// cpu/kernel/asm/core/access_lists.asm, re-designed for the word
// machine): per-transaction warm sets for addresses and storage slots.
// The reference keeps sorted linked lists; here both sets are plain
// append-only arrays in SEG_ACCESS with linear-scan membership —
// addresses one word each at [0..len), storage keys two words
// (acct_vptr, slot) at @ACCESS_SLOT_BASE + 2i.  Cold accesses journal
// the OLD length (@J_ALIST / @J_SLIST), so a frame revert re-cools
// exactly the accesses made inside the reverted frame
// (journal/access_lists rollback semantics).
//
// Gas consequences live at the call sites: SLOAD/SSTORE +2000/+2100
// cold surcharges (contract.asm), CALL-family +2500 cold-account
// surcharge, SELFDESTRUCT beneficiary +2600 (EIP-2929 values).
// Stack comments list the TOP first.

// warm_addr(addr, retdest) -> warm: 1 if addr was already accessed
// this transaction; else records it (journaled) and returns 0.
global warm_addr:
    // stack: addr, retdest
    PUSH 0                       // [i, addr, retdest]
wa_loop:
    %mload_global(@GLOBAL_ALIST_LEN)
    DUP2
    EQ
    %jumpi(wa_cold)
    DUP1
    PUSH @SEGMENT_ACCESS
    MLOAD_GENERAL                // [A[i], i, addr, retdest]
    DUP3
    EQ
    %jumpi(wa_warm)
    PUSH 1
    ADD
    %jump(wa_loop)
wa_warm:
    %stack (i, addr, retdest) -> (retdest, 1)
    JUMP
wa_cold:
    // stack: i(=len), addr, retdest
    %stack (len, addr) -> (@J_ALIST, len, 0, 0, wa_c1, len, addr)
    %jump(journal_append)
wa_c1:
    // stack: len, addr, retdest
    DUP1
    PUSH 1
    ADD
    %mstore_global(@GLOBAL_ALIST_LEN)
    %stack (len, addr) -> (@SEGMENT_ACCESS, len, addr)
    MSTORE_GENERAL               // A[len] = addr ; [retdest]
    PUSH 0
    SWAP1
    JUMP

// warm_addr_nojournal(addr): txn-start prewarming (origin, to,
// precompiles) — never reverted, so no journal entry.
%macro warm_addr_nojournal
    %mload_global(@GLOBAL_ALIST_LEN)
    DUP1
    PUSH 1
    ADD
    %mstore_global(@GLOBAL_ALIST_LEN)
    %stack (len, addr) -> (@SEGMENT_ACCESS, len, addr)
    MSTORE_GENERAL
%endmacro

// warm_slot(vptr, slot, retdest) -> warm: the storage-key set, keyed
// by the account's state-trie value pointer (one per address) + slot.
global warm_slot:
    // stack: vptr, slot, retdest
    PUSH 0                       // [i, vptr, slot, retdest]
ws_loop:
    %mload_global(@GLOBAL_SLIST_LEN)
    DUP2
    EQ
    %jumpi(ws_cold)
    DUP1
    DUP1
    ADD
    PUSH @ACCESS_SLOT_BASE
    ADD                          // [a = base + 2i, i, vptr, slot, retdest]
    DUP1
    PUSH @SEGMENT_ACCESS
    MLOAD_GENERAL                // [S[2i], a, i, vptr, slot, retdest]
    DUP4
    EQ
    ISZERO
    %jumpi(ws_next)
    PUSH 1
    ADD
    PUSH @SEGMENT_ACCESS
    MLOAD_GENERAL                // [S[2i+1], i, vptr, slot, retdest]
    DUP4
    EQ
    %jumpi(ws_warm)
    %jump(ws_next2)
ws_next:
    POP                          // [i, vptr, slot, retdest]
ws_next2:
    PUSH 1
    ADD
    %jump(ws_loop)
ws_warm:
    %stack (i, vptr, slot, retdest) -> (retdest, 1)
    JUMP
ws_cold:
    // stack: i(=len), vptr, slot, retdest
    %stack (len, vptr, slot) -> (@J_SLIST, len, 0, 0, ws_c1, len, vptr, slot)
    %jump(journal_append)
ws_c1:
    // stack: len, vptr, slot, retdest
    DUP1
    PUSH 1
    ADD
    %mstore_global(@GLOBAL_SLIST_LEN)
    DUP1
    ADD
    PUSH @ACCESS_SLOT_BASE
    ADD                          // [a, vptr, slot, retdest]
    %stack (a, vptr, slot) -> (@SEGMENT_ACCESS, a, vptr, a, slot)
    MSTORE_GENERAL               // S[a] = vptr ; [a, slot, retdest]
    PUSH 1
    ADD
    %stack (a1, slot) -> (@SEGMENT_ACCESS, a1, slot)
    MSTORE_GENERAL               // S[a+1] = slot ; [retdest]
    PUSH 0
    SWAP1
    JUMP

// access_lists_init(retdest): reset both sets and prewarm the EIP-2929
// defaults — tx.origin, tx.to and the precompiled contracts 1..9.
global access_lists_init:
    PUSH 0
    %mstore_global(@GLOBAL_ALIST_LEN)
    PUSH 0
    %mstore_global(@GLOBAL_SLIST_LEN)
    %mload_global(@GLOBAL_TXN_SENDER)
    %warm_addr_nojournal
    %mload_global(@GLOBAL_TXN_TO)
    %warm_addr_nojournal
    PUSH 1                       // [p, retdest]
ali_pc:
    DUP1
    PUSH 10
    EQ
    %jumpi(ali_done)
    DUP1
    %warm_addr_nojournal
    PUSH 1
    ADD
    %jump(ali_pc)
ali_done:
    POP
    JUMP
