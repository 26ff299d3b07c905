// Exception handlers (twin of reference
// cpu/kernel/asm/core/exception.asm).  Each handler re-verifies in
// software that the fault it was trapped for actually occurred, and
// PANICs otherwise — the prover cannot fake an exception on a valid
// operation.  On entry the stack holds the faulting instruction's
// remaining operands below the trap word (pc, 0, .., gas, 0).

global exc_out_of_gas:
    // stack: trap
    %mload_global(@GLOBAL_GASLIMIT)
    DUP2
    PUSH 192
    SHR                          // [trap, limit, gas_used]
    GT                           // gas_used > limit
    %jumpi(fault_exception)
    %jump(panic)

global exc_invalid_opcode:
    // stack: trap
    DUP1
    %opcode_from_trap_info       // [trap, opcode]
    %mload_global(@GLOBAL_INVALID_OPCODES_USER)
    SWAP1                        // [trap, mask, opcode]
    SHR
    PUSH 1
    AND                          // [trap, opcode_is_invalid]
    %jumpi(fault_exception)
    %jump(panic)

global exc_stack_underflow:
    // stack: trap
    GET_SP                       // [trap, user_sp + 1]
    PUSH 1
    SWAP1
    SUB                          // [trap, user_sp]
    DUP2
    %opcode_from_trap_info       // [trap, user_sp, opcode]
    PUSH @GLOBAL_MIN_SP_BASE
    ADD
    PUSH @SEGMENT_GLOBAL
    MLOAD_GENERAL                // [trap, user_sp, min_sp]
    SWAP1
    LT                           // user_sp < min_sp
    %jumpi(fault_exception)
    %jump(panic)

global exc_invalid_jump:
    // stack: dst, trap
    DUP1
    %opcode_from_trap_info       // [dst, trap, opcode]
    PUSH 0x56
    EQ
    ISZERO
    %jumpi(panic)                // the trapped op must be JUMP
    SWAP1                        // [trap, dst]
    %jump(check_jumpdest_invalid)

global exc_invalid_jumpi:
    // stack: cond, dst, trap
    DUP1
    %opcode_from_trap_info
    PUSH 0x57
    EQ
    ISZERO
    %jumpi(panic)                // the trapped op must be JUMPI
    SWAP2                        // [trap, dst, cond]
    ISZERO
    %jumpi(panic)                // cond == 0 would not have jumped
    %jump(check_jumpdest_invalid)

check_jumpdest_invalid:
    // stack: trap, dst — fault iff dst >= 2^32 or jumpdest bit unset
    DUP1
    PUSH 0x100000000
    SWAP1
    LT                           // [trap, dst, dst < 2^32]
    ISZERO
    %jumpi(fault_oversized_dst)
    GET_CONTEXT
    %seg_of(@SEGMENT_JUMPDEST)   // jumpdest bits live with the code
    MLOAD_GENERAL                // [trap, jumpdest_bit]
    ISZERO
    %jumpi(fault_exception)
    %jump(panic)

fault_oversized_dst:
    // stack: trap, dst
    POP
    %jump(fault_exception)

global exc_stack_overflow:
    // stack: trap
    GET_SP
    PUSH 1025
    EQ                           // user_sp + 1 == 1025
    ISZERO
    %jumpi(panic)
    DUP1
    %opcode_from_trap_info       // [trap, opcode]
    %mload_global(@GLOBAL_STACK_INCREASING_USER)
    SWAP1
    SHR
    PUSH 1
    AND                          // the op must grow the stack
    %jumpi(fault_exception)
    %jump(panic)
