// Syscall handlers (twin of reference cpu/kernel/asm/memory/ and
// asm/core routines reached through the syscall jumptable,
// cpu/syscalls.rs).  On entry the stack holds the user operands below
// the trap word (pc+1, kernel_flag, 0.., gas, 0); each handler does
// its work, charges the opcode's gas into the trap word's limb 6, and
// EXIT_KERNELs back to user code.
//
// Round-2 divergences from the reference (documented in opcodes.py):
// user MLOAD/MSTORE are word-granular on SEGMENT_MAIN, MSTORE8 and
// KECCAK256 address the byte-granular SEGMENT_BYTES, and dynamic gas
// components (per-word keccak cost, exp byte cost) are flat.

global sys_stop:
    // stack: trap — a successful halt must be inside the block gas
    // limit.  The AIR only accumulates GAS (gas.rs equivalent) and never
    // compares it, so this software check is what forces the out-of-gas
    // semantics: an over-limit execution cannot reach HALT and its only
    // provable exit is exc_out_of_gas (which re-verifies gas_used >
    // limit); the reference leaves exc_out_of_gas as TODO
    // (cpu/kernel/asm/core/exception.asm:26).
    // In a contract frame (context != 0) STOP ends the frame with
    // success and empty returndata instead (contract.asm).
    GET_CONTEXT
    %jumpi(sys_stop_contract)
    %mload_global(@GLOBAL_GASLIMIT)
    DUP2
    PUSH 192
    SHR                          // [trap, limit, gas_used]
    GT                           // [trap, gas_used > limit]
    %jumpi(panic)
    POP
    HALT

sys_stop_contract:
    // stack: trap — success, empty returndata (contract.asm)
    PUSH 0
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    PUSH 1
    %jump(contract_exit)

global sys_mload:
    // stack (top first): trap, addr — word addr a occupies bytes
    // [32a, 32a+32): memory expands to 32*(a+1) bytes (gas.asm note)
    DUP2
    PUSH 1
    ADD
    PUSH 5
    SHL                          // [end, trap, addr]
    %charge_memory               // [trap, addr]
    SWAP1
    GET_CONTEXT
    %seg_of(@SEGMENT_MAIN)       // user memory is per-context
    MLOAD_GENERAL                // [trap, value]
    SWAP1
    %charge_gas(3)
    EXIT_KERNEL

global sys_mstore:
    // stack (top first): trap, offset, value
    DUP2
    PUSH 1
    ADD
    PUSH 5
    SHL                          // [end, trap, offset, value]
    %charge_memory               // [trap, offset, value]
    SWAP2                        // [trap, offset, value]
    SWAP1                        // [trap, value, offset]
    GET_CONTEXT
    %seg_of(@SEGMENT_MAIN)
    MSTORE_GENERAL               // [trap]
    %charge_gas(3)
    EXIT_KERNEL

global sys_mstore8:
    // stack (top first): trap, offset, value
    DUP2
    PUSH 1
    ADD                          // [end = offset+1, trap, offset, value]
    %charge_memory
    SWAP2                        // [trap, offset, value]
    PUSH 0xff
    AND                          // [trap, offset, byte]
    SWAP1                        // [trap, byte, offset]
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)
    MSTORE_GENERAL               // [trap]
    %charge_gas(3)
    EXIT_KERNEL

global sys_keccak256:
    // stack (top first): trap, offset, len
    DUP3
    DUP3
    ADD                          // [end = offset+len, trap, offset, len]
    %charge_memory               // [trap, offset, len]
    // dynamic gas: 30 + 6 * ceil(len/32) (gas.rs keccak word cost)
    DUP3
    PUSH 31
    ADD
    PUSH 5
    SHR
    PUSH 6
    MUL
    PUSH 192
    SHL
    ADD                          // [trap', offset, len]
    SWAP2
    SWAP1
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)
    KECCAK_GENERAL               // [digest, trap]
    SWAP1
    %charge_gas(30)
    EXIT_KERNEL

global sys_gas:
    // stack: trap — push gas remaining = block limit - gas used
    %mload_global(@GLOBAL_GASLIMIT)
    DUP2
    PUSH 192
    SHR                          // [trap, limit, gas_used]
    SWAP1                        // [trap, gas_used, limit]
    SUB                          // [trap, limit - gas_used]
    SWAP1
    %charge_gas(2)
    EXIT_KERNEL

// EXP by square-and-multiply mod 2^256 (asm/exp.asm; loop exits as
// soon as the remaining exponent is 0)
global sys_exp:
    // stack: exponent, base, trap
    SWAP2                        // [trap, base, exponent]
    PUSH 1                       // [trap, base, exp, acc]
exp_loop:
    DUP2
    ISZERO
    %jumpi(exp_end)
    DUP2
    PUSH 1
    AND
    ISZERO
    %jumpi(exp_skip)
    DUP3
    MUL                          // acc *= base
exp_skip:
    SWAP2                        // [trap, acc, exp, base]
    DUP1
    MUL                          // [trap, acc, exp, base^2]
    SWAP2                        // [trap, base^2, exp, acc]
    SWAP1                        // [trap, base^2, acc, exp]
    PUSH 1
    SHR                          // [trap, base^2, acc, exp >> 1]
    SWAP1                        // [trap, base^2, exp, acc]
    %jump(exp_loop)
exp_end:
    // stack: trap, base, 0, acc
    SWAP2                        // [trap, acc, 0, base]
    POP
    POP                          // [trap, acc]
    SWAP1
    %charge_gas(10)
    EXIT_KERNEL
