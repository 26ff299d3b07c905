// Gas fidelity: intrinsic calldata gas, per-frame memory expansion,
// MSIZE (twin of reference cpu/kernel/asm/core/intrinsic_gas.asm +
// memory/metadata.asm %update_mem_bytes / gas.rs memory costs).
//
// Frame memory size is tracked in 32-byte words per context
// (@CTX_MSIZE); expansion charges the EVM quadratic schedule
// C(w) = 3w + floor(w^2/512), charge = C(w') - C(w).  The word-machine
// reduction: user MLOAD/MSTORE are word-granular on SEGMENT_MAIN, so a
// word address a expands memory to 32*(a+1) bytes; byte-granular ops
// (MSTORE8/KECCAK256/copies/LOG/CALL windows/RETURN) use their byte
// extents directly.  Both feed the same per-frame word counter, as the
// reference's single MSIZE does.
//
// Stack comments list the TOP first.

// charge_memory_fn(end, trap, retdest) -> (trap'): expand the current
// frame's memory to `end` bytes, charging into the trap's gas limb.
global charge_memory_fn:
    // stack: end, trap, retdest
    PUSH 31
    ADD
    PUSH 5
    SHR                          // [w' = ceil(end/32), trap, retdest]
    %push_ctx_meta(@CTX_MSIZE)   // [w, w', trap, retdest]
    DUP2
    DUP2
    LT                           // [w < w', w, w', trap, retdest]
    %jumpi(cm_grow)
    POP
    POP
    SWAP1
    JUMP
cm_grow:
    // stack: w, w', trap, retdest
    GET_CONTEXT
    %seg_of(@SEGMENT_CTX_META)
    %stack (cmsw, w, wp) -> (cmsw, @CTX_MSIZE, wp, w, wp)
    MSTORE_GENERAL               // [w, w', trap, retdest]
    // cost = 3*(w'-w) + (floor(w'^2/512) - floor(w^2/512))
    DUP1
    DUP1
    MUL
    PUSH 9
    SHR                          // [w^2>>9, w, w', trap, retdest]
    DUP3
    DUP1
    MUL
    PUSH 9
    SHR                          // [w'^2>>9, w^2>>9, w, w', trap, retdest]
    SUB                          // [quad, w, w', trap, retdest]
    %stack (quad, w, wp) -> (wp, w, quad)
    SUB                          // [w'-w, quad, trap, retdest]
    PUSH 3
    MUL
    ADD                          // [cost, trap, retdest]
    PUSH 192
    SHL
    ADD                          // [trap', retdest]
    SWAP1
    JUMP

// [end, trap, ..] -> [trap', ..]
%macro charge_memory
    %stack (end, trap) -> (end, trap, %%cm)
    %jump(charge_memory_fn)
%%cm:
%endmacro

// MSIZE (0x59): the frame's memory size in bytes (32 * words)
global sys_msize:
    // stack: trap
    %push_ctx_meta(@CTX_MSIZE)
    PUSH 5
    SHL                          // [msize_bytes, trap]
    SWAP1
    %charge_gas(2)
    EXIT_KERNEL

// compute_intrinsic_gas(retdest): @GLOBAL_INTRINSIC_GAS = 21000 +
// 4 per zero calldata byte + 16 per nonzero byte (EIP-2028;
// reference core/intrinsic_gas.asm).
global compute_intrinsic_gas:
    %mload_global(@GLOBAL_TXN_DATA_LEN)
    PUSH 21000
    PUSH 0                       // [i, g, n, retdest]
cig_loop:
    DUP3
    DUP2
    EQ
    %jumpi(cig_done)
    // b = BYTE(i & 31, GLOBAL[DATA_BASE + (i >> 5)])
    DUP1
    PUSH 5
    SHR
    PUSH @GLOBAL_TXN_DATA_BASE
    ADD
    PUSH @SEGMENT_GLOBAL
    MLOAD_GENERAL                // [word, i, g, n, retdest]
    DUP2
    PUSH 31
    AND
    BYTE                         // [b, i, g, n, retdest]
    ISZERO
    %jumpi(cig_zero)
    SWAP1
    PUSH 16
    ADD
    SWAP1
    %jump(cig_next)
cig_zero:
    SWAP1
    PUSH 4
    ADD
    SWAP1
cig_next:
    PUSH 1
    ADD
    %jump(cig_loop)
cig_done:
    // stack: i, g, n, retdest
    %stack (i, g, n) -> (g)
    %mstore_global(@GLOBAL_INTRINSIC_GAS)
    JUMP
