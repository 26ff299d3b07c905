"""EVM opcode metadata: decode blocks, gas costs, stack behaviors.

Twin of reference evm/src/cpu/decode.rs:25 (OPCODES block table),
cpu/gas.rs:20 (SIMPLE_OPCODES cost table) and cpu/stack.rs:41
(STACK_BEHAVIORS).  Each *native* instruction (one CPU row) is a block
of opcodes: contiguous, power-of-2 length, aligned, and available to
the user, only the kernel, or both.  Every other opcode executes as a
SYSCALL row trapping into the kernel's syscall jumptable — including
invalid opcodes, whose jumptable entries point at the invalid-opcode
exception path (decode.rs:23 note).

Differences from the reference, by design (word-granular TPU machine):
- code is word-addressed — one (opcode word, immediate word) pair per
  instruction, so all PUSH1..PUSH32 (0x60..0x7f) decode to one `push`
  flag whose value is the immediate word (the reference reads n code
  bytes instead);
- execution contexts (round 4): `get_context` (0xf4) / `set_context`
  (0xf5) are kernel-only natives; SET_CONTEXT hardware-swaps SP through
  the per-context metadata slot (ctx, SEG_CTX_META, META_SP) like the
  reference's stack-length bookkeeping (cpu/contextops.rs).  General
  memory ops keep their (segword, virt) operand shape: the CONTEXT of
  the access rides limb 1 of the segment word (segword = ctx<<32 | seg),
  so kernel code addressing context 0 is unchanged and cross-context
  copies need no context switching;
- STOP (0x00) is the kernel-only native `halt`; user STOP traps to the
  kernel like any syscall (reference halts via a kernel jump loop,
  control_flow.rs:52).
"""

from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------- gas
# (gas.rs:12-18)
KERNEL_ONLY = 0
G_JUMPDEST = 1
G_BASE = 2
G_VERYLOW = 3
G_LOW = 5
G_MID = 8
G_HIGH = 10


@dataclass(frozen=True)
class NativeOp:
    """One decode block (decode.rs:25 tuple + gas/stack metadata)."""

    name: str
    opcode: int          # start index of the block
    block_bits: int      # log2 of block length (0 => single opcode)
    kernel_only: bool
    gas: int | None      # None => special handling (syscall/exception/…)
    pops: int            # stack pops (channels 1..pops read sp-1..sp-pops)
    pushes: bool         # one push on channel 4
    sp_delta: int        # next_sp - sp


def _op(name, opcode, gas, pops, pushes, *, bits=0, kernel=False,
        sp_delta=None):
    if sp_delta is None:
        sp_delta = (1 if pushes else 0) - pops
    return NativeOp(name, opcode, bits, kernel, gas, pops, pushes, sp_delta)


# The native instruction blocks (decode.rs:25).  Order fixes the flag
# column order in the CPU table.
NATIVE_OPS = (
    _op("halt", 0x00, None, 0, False, kernel=True),
    _op("add", 0x01, G_VERYLOW, 2, True),
    _op("mul", 0x02, G_LOW, 2, True),
    _op("sub", 0x03, G_VERYLOW, 2, True),
    _op("div", 0x04, G_LOW, 2, True),
    _op("mod", 0x06, G_LOW, 2, True),
    _op("addmod", 0x08, G_MID, 3, True),
    _op("mulmod", 0x09, G_MID, 3, True),
    _op("addfp254", 0x0C, KERNEL_ONLY, 2, True, kernel=True),
    _op("mulfp254", 0x0D, KERNEL_ONLY, 2, True, kernel=True),
    _op("subfp254", 0x0E, KERNEL_ONLY, 2, True, kernel=True),
    _op("lt", 0x10, G_VERYLOW, 2, True),
    _op("gt", 0x11, G_VERYLOW, 2, True),
    _op("eq", 0x14, G_VERYLOW, 2, True),
    _op("iszero", 0x15, G_VERYLOW, 1, True),
    _op("and", 0x16, G_VERYLOW, 2, True),
    _op("or", 0x17, G_VERYLOW, 2, True),
    _op("xor", 0x18, G_VERYLOW, 2, True),
    _op("not", 0x19, G_VERYLOW, 1, True),
    _op("byte", 0x1A, G_VERYLOW, 2, True),
    _op("shl", 0x1B, G_VERYLOW, 2, True),
    _op("shr", 0x1C, G_VERYLOW, 2, True),
    _op("keccak_general", 0x21, KERNEL_ONLY, 3, True, kernel=True),
    _op("prover_input", 0x49, KERNEL_ONLY, 0, True, kernel=True),
    _op("pop", 0x50, G_BASE, 1, False),
    _op("jump", 0x56, G_MID, 1, False),
    _op("jumpi", 0x57, G_HIGH, 2, False),
    _op("pc", 0x58, G_BASE, 0, True),
    _op("jumpdest", 0x5B, G_JUMPDEST, 0, False),
    _op("push0", 0x5F, G_BASE, 0, True),
    _op("push", 0x60, G_VERYLOW, 0, True, bits=5),
    _op("dup", 0x80, G_VERYLOW, 0, True, bits=4),
    _op("swap", 0x90, G_VERYLOW, 0, False, bits=4),
    _op("get_context", 0xF4, KERNEL_ONLY, 0, True, kernel=True),
    _op("set_context", 0xF5, KERNEL_ONLY, 1, False, kernel=True),
    _op("get_sp", 0xF6, KERNEL_ONLY, 0, True, kernel=True),
    _op("exit_kernel", 0xF9, None, 1, False, kernel=True),
    _op("mload_general", 0xFB, KERNEL_ONLY, 2, True, kernel=True),
    _op("mstore_general", 0xFC, KERNEL_ONLY, 3, False, kernel=True),
)

# Row-level pseudo-ops: not decoded from an opcode block; `syscall` fires
# for any opcode without an available native block, `exception` for
# user-mode faults (syscalls.rs / exceptions.rs).  Both push one word.
ROW_OPS = ("syscall", "exception")
ALL_FLAGS = tuple(op.name for op in NATIVE_OPS) + ROW_OPS

BY_NAME = {op.name: op for op in NATIVE_OPS}


def decode_native(opcode: int, kernel_mode: bool) -> NativeOp | None:
    """The native block containing `opcode` that is available in the
    given mode, or None (=> SYSCALL row) (decode.rs:104 generate)."""
    for op in NATIVE_OPS:
        if op.kernel_only and not kernel_mode:
            continue
        if (opcode >> op.block_bits) == (op.opcode >> op.block_bits):
            return op
    return None


# ---------------------------------------------------------- exceptions
# (kernel/asm/core/exception.asm:1 jumptable order)
EXC_OUT_OF_GAS = 0
EXC_INVALID_OPCODE = 1
EXC_STACK_UNDERFLOW = 2
EXC_INVALID_JUMP = 3
EXC_INVALID_JUMPI = 4
EXC_STACK_OVERFLOW = 5
NUM_EXC_CODES = 8

# (stack_bounds.rs:21)
MAX_USER_STACK_SIZE = 1024


def min_stack_len(opcode: int) -> int:
    """Minimum user stack length for an opcode — the underflow bound
    (kernel min_stack_len_for_opcode table, asm/core/exception.asm:141).
    For syscall'd opcodes this is the number of operands their kernel
    handler consumes before pushing; unknown/invalid opcodes need 0."""
    op = decode_native(opcode, kernel_mode=False)
    if op is not None:
        if op.name == "dup":
            return (opcode & 0xF) + 1
        if op.name == "swap":
            return (opcode & 0xF) + 2
        return op.pops
    return SYSCALL_MIN_STACK.get(opcode, 0)


# user-visible syscall'd opcodes the round-2 kernel implements, with the
# operand count their handlers pop (used for the underflow table)
SYSCALL_MIN_STACK = {
    0x00: 0,   # STOP
    0x20: 2,   # KECCAK256(offset, len)
    0x0A: 2,   # EXP(base, exponent)
    0x51: 1,   # MLOAD(addr)
    0x52: 2,   # MSTORE(addr, value)
    0x53: 2,   # MSTORE8(addr, byte)
    0x5A: 0,   # GAS
    # signed arithmetic (kernel/asm/signed.asm); without these entries
    # min_stack_len returns 0 and a 1-item SDIV would run the handler
    # against whatever sits below instead of EXC_STACK_UNDERFLOW
    0x05: 2,   # SDIV(a, b)
    0x07: 2,   # SMOD(a, b)
    0x0B: 2,   # SIGNEXTEND(k, value)
    0x12: 2,   # SLT(a, b)
    0x13: 2,   # SGT(a, b)
    0x1D: 2,   # SAR(shift, value)
    # contract-frame syscalls (kernel/asm/contract.asm)
    0x35: 1,   # CALLDATALOAD(i)
    0x54: 1,   # SLOAD(slot)
    0x55: 2,   # SSTORE(slot, value)
    0xF3: 2,   # RETURN(offset, len)
    0xFD: 2,   # REVERT(offset, len)
    # inner message calls (round 5, kernel/asm/contract.asm sys_call)
    0xF1: 7,   # CALL(gas, addr, value, argsOff, argsSize, retOff, retSize)
    0xF4: 6,   # DELEGATECALL(gas, addr, argsOff, argsSize, retOff, retSize)
    0xFA: 6,   # STATICCALL(gas, addr, argsOff, argsSize, retOff, retSize)
    0xF2: 7,   # CALLCODE(gas, addr, value, argsOff, argsSize, retOff, retSize)
    0x3D: 0,   # RETURNDATASIZE
    0x3E: 3,   # RETURNDATACOPY(destOff, off, len)

    0xA0: 2,   # LOG0(offset, size)
    0xA1: 3,   # LOG1(offset, size, t1)
    0xA2: 4,   # LOG2(offset, size, t1, t2)
    0xA3: 5,   # LOG3(offset, size, t1, t2, t3)
    0xA4: 6,   # LOG4(offset, size, t1..t4)

    0xF0: 3,   # CREATE(value, offset, size)
    0xF5: 4,   # CREATE2(value, offset, size, salt)

    0x59: 0,   # MSIZE
    0xFF: 1,   # SELFDESTRUCT(beneficiary)
}
