// Core macros + panic/fault plumbing (twin of reference
// cpu/kernel/asm/core/{exception.asm,terminate.asm} helpers and
// asm/util.asm, re-targeted at the word machine).

%macro jump(dest)
    PUSH $dest
    JUMP
%endmacro

%macro jumpi(dest)
    PUSH $dest
    JUMPI
%endmacro

// [.., x] -> [.., value] : value = SEGMENT_GLOBAL[$idx]
%macro mload_global(idx)
    PUSH $idx
    PUSH @SEGMENT_GLOBAL
    MLOAD_GENERAL
%endmacro

// [.., value] -> [..] : SEGMENT_GLOBAL[$idx] = value
%macro mstore_global(idx)
    PUSH $idx
    PUSH @SEGMENT_GLOBAL
    MSTORE_GENERAL
%endmacro

// [.., trap_copy] -> [.., opcode] : the opcode word at the trapped pc
// (reference %opcode_from_exp_trap_info, core/exception.asm:137)
%macro opcode_from_trap_info
    PUSH 0xffffffff
    AND
    DUP1
    ADD
    GET_CONTEXT
    %seg_of(@SEGMENT_CODE)       // the faulting code's context
    MLOAD_GENERAL
%endmacro

// [.., trap_copy] -> [.., opcode] : the opcode that raised a SYSCALL.
// Syscall traps save pc+1 (the continuation) where exception traps
// save the faulting pc, hence the extra -1 vs %opcode_from_trap_info.
%macro opcode_from_syscall_trap
    PUSH 0xffffffff
    AND
    PUSH 1
    SWAP1
    SUB                          // [pc = (trap & m32) - 1, ..]
    DUP1
    ADD
    GET_CONTEXT
    %seg_of(@SEGMENT_CODE)
    MLOAD_GENERAL
%endmacro

// [.., trap] -> [.., trap + $cost<<192] : charge gas in the saved word
%macro charge_gas(cost)
    PUSH $cost
    PUSH 192
    SHL
    ADD
%endmacro

// PANIC: an exception handler entered without cause spins forever, so
// the mandatory final HALT row is unreachable and no proof exists
// (reference PANIC opcode, decode.rs:20 note).
global panic:
    %jump(panic)

// exceptional exit: in a contract frame (context != 0) a user fault
// fails the transaction and journal-reverts (contract.asm
// contract_fault, reference core/terminate.asm); at the top level it
// records the fault and halts (round-2 reduction)
global fault_exception:
    GET_CONTEXT
    %jumpi(contract_fault)
    PUSH 1
    %mstore_global(@GLOBAL_EXC_STATUS)
    HALT
