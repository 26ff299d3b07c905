// Precompiled contracts (reduced twin of reference
// cpu/kernel/asm/core/precompiles/{main,ecrec,id,expmod}.asm).
//
// Dispatch: sys_call (contract.asm) routes CALLs to addresses 1..9
// here AFTER the value transfer; the precompile runs directly in
// kernel mode in the caller's context (no child frame — the reference
// spins up a stub context; the observable behavior is the same: input
// from the caller's byte memory, output in RETURNDATA, CALL pushes the
// status).  Implemented: 0x01 ecrecover (curve.asm Jacobian ladder;
// its three inversion hints ride the shared PROVER_INPUT stream —
// transfer.py GenerationInputs.extra_prover_inputs), 0x04 identity,
// 0x05 expmod (EIP-198 with operands <= 32 bytes each — the word
// machine's MULMOD is 256-bit; larger operands would need the
// reference's bignum library, a documented reduction).  0x02 sha256,
// 0x03 ripemd160, 0x06/0x07 bn_add/bn_mul and 0x09 blake2f live in
// their own files.  The one unimplemented address (8, snarkv) PANICs:
// a block calling it is unprovable rather than wrongly executed.
// An INVALID signature to 0x01 also
// PANICs (the reference returns empty; unprovable-vs-empty is a
// completeness reduction only).
//
// Entry stack (from contract.asm sc_precompile): addr, trap, value,
// ao, asz, ro, rs.  Exit: pc_done leaves [trap, ro, rs], sets
// @GLOBAL_FRAME_STATUS = 1 and joins sys_call's shared returndata-copy
// return path (sc_ret_precompile).
// Stack comments list the TOP first.

global precompile_dispatch:
    // stack: addr, trap, value, ao, asz, ro, rs
    DUP1
    PUSH 1
    EQ
    %jumpi(pc_ecrec)
    DUP1
    PUSH 4
    EQ
    %jumpi(pc_identity)
    DUP1
    PUSH 5
    EQ
    %jumpi(pc_expmod)
    DUP1
    PUSH 2
    EQ
    %jumpi(pc_sha256)
    DUP1
    PUSH 6
    EQ
    %jumpi(pc_bn_add)
    DUP1
    PUSH 7
    EQ
    %jumpi(pc_bn_mul)
    DUP1
    PUSH 9
    EQ
    %jumpi(pc_blake2f)
    DUP1
    PUSH 3
    EQ
    %jumpi(pc_ripemd160)
    %jump(panic)

// ---- 0x01 ecrecover: input [hash(32) v(32) r(32) s(32)] at BYTES[ao];
// output = 32-byte left-padded address.  Reads past asz are fresh
// zeros, matching the EVM's implicit zero-padding.
pc_ecrec:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, trap, value, ao, asz, ro, rs]
    DUP4                         // [ao, bsw, trap, value, ao, asz, ro, rs]
    %stack (ao, bsw) -> (bsw, ao, 32, pc_ec1, bsw)
    %jump(mload_be_gen)
pc_ec1:
    // stack: hash, bsw, trap, value, ao, asz, ro, rs
    DUP2
    DUP6
    PUSH 32
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pc_ec2)
    %jump(mload_be_gen)
pc_ec2:
    // stack: v, hash, bsw, trap, value, ao, asz, ro, rs
    DUP3
    DUP7
    PUSH 64
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pc_ec3)
    %jump(mload_be_gen)
pc_ec3:
    // stack: r, v, hash, bsw, trap, value, ao, asz, ro, rs
    DUP4
    DUP8
    PUSH 96
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pc_ec4)
    %jump(mload_be_gen)
pc_ec4:
    // stack: s, r, v, hash, bsw, trap, value, ao, asz, ro, rs
    %stack (s, r, v, hash, bsw) -> (hash, v, r, s, pc_ec5)
    %jump(ecrecover)
pc_ec5:
    // stack: recovered, trap, value, ao, asz, ro, rs
    %stack (rec) -> (@SEGMENT_RETURNDATA, 0, rec, 32, pc_ec6)
    %jump(mstore_be_gen)
pc_ec6:
    PUSH 32
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %jump(pc_done)

// ---- 0x04 identity: returndata = input
pc_identity:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, trap, value, ao, asz, ro, rs]
    PUSH 0
pc_id_loop:
    // stack: i, bsw, trap, value, ao, asz, ro, rs
    DUP6
    DUP2
    EQ
    %jumpi(pc_id_done)
    DUP1
    DUP6
    ADD                          // [ao+i, i, bsw, trap, value, ao, asz, ro, rs]
    DUP3
    MLOAD_GENERAL                // [b, i, bsw, trap, value, ao, asz, ro, rs]
    DUP2
    PUSH @SEGMENT_RETURNDATA
    MSTORE_GENERAL               // [i, bsw, trap, value, ao, asz, ro, rs]
    PUSH 1
    ADD
    %jump(pc_id_loop)
pc_id_done:
    // stack: i, bsw, trap, value, ao, asz, ro, rs
    POP
    POP                          // [trap, value, ao, asz, ro, rs]
    DUP4                         // asz
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %jump(pc_done)

// ---- 0x05 expmod (EIP-198, one-word operands): input
// [Bsize(32) Esize(32) Msize(32) B E M] big-endian at BYTES[ao].
// Square-and-multiply over 256 exponent bits with MULMOD; scratch in
// fresh trie cells (base in @GLOBAL_EC_BASE — ecrecover re-allocates
// its own on entry, so reuse is safe):
//   +0 bsw  +1 ao+96  +2 bsize  +3 esize  +4 msize  +5 B  +6 E  +7 M
pc_expmod:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    PUSH 8
    %trie_alloc
    %mstore_global(@GLOBAL_EC_BASE)
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)
    %ec_store(0)
    DUP3                         // [ao, trap, value, ao, asz, ro, rs]
    PUSH 96
    ADD
    %ec_store(1)
    // bsize
    %ec_load(0)
    DUP4                         // [ao, bsw, trap, value, ao, asz, ro, rs]
    %stack (ao, bsw) -> (bsw, ao, 32, pc_em1)
    %jump(mload_be_gen)
pc_em1:
    // stack: bsize, trap, value, ao, asz, ro, rs
    DUP1
    PUSH 32
    LT                           // 32 < bsize ?
    %jumpi(panic)
    %ec_store(2)
    // esize
    %ec_load(0)
    DUP4
    PUSH 32
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pc_em2)
    %jump(mload_be_gen)
pc_em2:
    DUP1
    PUSH 32
    LT
    %jumpi(panic)
    %ec_store(3)
    // msize
    %ec_load(0)
    DUP4
    PUSH 64
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pc_em3)
    %jump(mload_be_gen)
pc_em3:
    DUP1
    PUSH 32
    LT
    %jumpi(panic)
    %ec_store(4)
    // B = BYTES[ao96 .. ao96+bsize)
    %ec_load(2)
    %ec_load(1)
    %ec_load(0)
    %stack (bsw, a, n) -> (bsw, a, n, pc_em4)
    %jump(mload_be_gen)
pc_em4:
    %ec_store(5)
    // E at ao96 + bsize
    %ec_load(3)
    %ec_load(2)
    %ec_load(1)
    ADD                          // [ao96+bsize, esize, ...]
    %ec_load(0)
    %stack (bsw, a, n) -> (bsw, a, n, pc_em5)
    %jump(mload_be_gen)
pc_em5:
    %ec_store(6)
    // M at ao96 + bsize + esize
    %ec_load(4)
    %ec_load(3)
    %ec_load(2)
    ADD
    %ec_load(1)
    ADD                          // [moff, msize, ...]
    %ec_load(0)
    %stack (bsw, a, n) -> (bsw, a, n, pc_em6)
    %jump(mload_be_gen)
pc_em6:
    %ec_store(7)
    // result = B^E mod M (M = 0 -> 0, EIP-198)
    %ec_load(7)
    ISZERO
    %jumpi(pc_em_zero)
    PUSH 1                       // acc
    PUSH 256                     // i
pc_em_loop:
    // stack: i, acc, trap, value, ao, asz, ro, rs
    DUP1
    ISZERO
    %jumpi(pc_em_done)
    PUSH 1
    SWAP1
    SUB                          // [i-1, acc, ...]
    SWAP1                        // [acc, i, ...]
    DUP1
    %ec_load(7)                  // [M, acc, acc, i, ...]
    SWAP2                        // [acc, acc, M, i, ...]
    MULMOD                       // [acc^2, i, ...]
    %ec_load(6)                  // [E, acc, i, ...]
    DUP3                         // [i, E, acc, i, ...]
    SHR
    PUSH 1
    AND
    ISZERO
    %jumpi(pc_em_next)
    %ec_load(5)                  // [B, acc, i, ...]
    %ec_load(7)                  // [M, B, acc, i, ...]
    SWAP2                        // [acc, B, M, i, ...]
    MULMOD                       // [acc*B mod M, i, ...]
pc_em_next:
    SWAP1                        // [i, acc, ...]
    %jump(pc_em_loop)
pc_em_done:
    // stack: 0, acc, trap, value, ao, asz, ro, rs
    POP
    %jump(pc_em_out)
pc_em_zero:
    PUSH 0
pc_em_out:
    // stack: acc, trap, value, ao, asz, ro, rs
    %ec_load(4)                  // [msize, acc, ...]
    DUP1
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %stack (msize, acc) -> (@SEGMENT_RETURNDATA, 0, acc, msize, pc_em_fin)
    %jump(mstore_be_gen)
pc_em_fin:
    %jump(pc_done)

pc_done:
    // stack: trap, value, ao, asz, ro, rs — success; shared exit path
    PUSH 1
    %mstore_global(@GLOBAL_FRAME_STATUS)
    %stack (trap, value, ao, asz, ro, rs) -> (trap, ro, rs)
    %jump(sc_ret_precompile)
