"""Witness generation + AllStark wiring for the zkEVM pipeline (twin of
reference evm/src/generation/mod.rs, witness/{traces,transition}.rs and
all_stark.rs).

`Simulator` executes the kernel (and optionally a user program) on the
full CPU (cpu.py), logging every memory access, arithmetic/logic
request, keccak sponge call and CPU row into `Traces`
(checkpoint/rollback as witness/traces.rs:20).  It doubles as the
off-chain `Interpreter` for kernel unit tests (kernel/interpreter.rs:39)
— run with trace=False to skip witness logging.  User-mode faults trap
through the exception jumptable exactly as the AIR requires
(witness/transition.rs); kernel code is trusted and asserts instead.

`generate_traces` turns the logs into per-table trace arrays;
`all_cross_table_lookups` assembles the CTL wiring (all_stark.rs:99);
`prove_program` / `verify_program_proof` run the shared-transcript
multi-table prover (stark/multi.py), with the bootstrap image bound to
the public kernel + user code through the program ROM (program.py).
Simulation and trace generation are host work; the prove and the ROM
commitment the verifier recomputes run on a device (CUDA unless the
caller names another).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..field import gl64
from ..stark.config import StarkConfig
from ..stark.ctl import CrossTableLookup, TableWithColumns
from ..stark.multi import prove_multi_table, verify_multi_table
from ..utils.cuda import resolve_device
from ..utils.timing import TimingTree
from .arithmetic import ArithmeticStark, Operation
from .cpu import (KECCAK_TS_CH, LOGIC_OPS, META_SP, NUM_CHANNELS,
                  SEG_BYTES, SEG_CODE, SEG_CTX_META, SEG_GLOBAL,
                  SEG_JUMPDEST, SEG_JUMPTABLE, SEG_MAIN, SEG_SHIFT,
                  SEG_STACK, TS_STRIDE, WORD_LIMBS, CpuStark)
from .kernel import KERNEL
from .kernel.aggregator import (DEFAULT_BLOCK_GASLIMIT,
                                GLOBAL_BLOCK_GASLIMIT, GLOBAL_EXC_STATUS,
                                user_opcode_is_valid)
from .logic import LogicStark
from .memory import MemoryOp, MemoryStark
from .opcodes import (EXC_INVALID_JUMP, EXC_INVALID_JUMPI,
                      EXC_INVALID_OPCODE, EXC_OUT_OF_GAS,
                      EXC_STACK_OVERFLOW, EXC_STACK_UNDERFLOW,
                      MAX_USER_STACK_SIZE, decode_native, min_stack_len)

P = gl64.ORDER_INT
WORD_MASK = (1 << 256) - 1
U32 = 1 << 32

# canonical table indices (all_stark.rs:75 Table enum); PROGRAM last
CPU, MEMORY, LOGIC, ARITHMETIC = 0, 1, 2, 3

ARITH_NATIVE = {"add", "mul", "sub", "div", "mod", "lt", "gt", "byte",
                "addmod", "mulmod", "addfp254", "mulfp254", "subfp254"}

# user opcodes that grow the stack via their syscall handler (GAS) —
# shared with the kernel's GLOBAL_STACK_INCREASING_USER bitmask so the
# exc_stack_overflow handler accepts the trap the simulator takes
from .kernel.aggregator import SYSCALL_STACK_INCREASING


@dataclass
class Traces:
    """Operation logs with checkpoint/rollback (witness/traces.rs)."""

    memory_ops: list = field(default_factory=list)
    arithmetic_ops: list = field(default_factory=list)
    logic_ops: list = field(default_factory=list)
    sponge_ops: list = field(default_factory=list)
    cpu_rows: list = field(default_factory=list)

    def checkpoint(self) -> tuple:
        return (len(self.memory_ops), len(self.arithmetic_ops),
                len(self.logic_ops), len(self.sponge_ops),
                len(self.cpu_rows))

    def rollback(self, cp: tuple) -> None:
        m, a, l, s, c = cp
        del self.memory_ops[m:]
        del self.arithmetic_ops[a:]
        del self.logic_ops[l:]
        del self.sponge_ops[s:]
        del self.cpu_rows[c:]


def _limbs(v: int) -> list:
    return [(v >> (32 * j)) & 0xFFFFFFFF for j in range(WORD_LIMBS)]


def _inv(x: int) -> int:
    return pow(x % P, P - 2, P) if x % P else 0


class Halted(Exception):
    pass


class Simulator:
    """Executes the kernel + user program, emitting CPU rows and table
    requests (generation/state.rs GenerationState + the transition
    function, witness/transition.rs).  With trace=False it is the
    off-chain Interpreter (kernel/interpreter.rs:39)."""

    def __init__(self, user_code: list | None = None, kernel=None,
                 global_values: dict | None = None, prover_inputs=(),
                 max_cycles: int = 30_000, trace: bool = True):
        self.kernel = kernel or KERNEL
        self.user_code = list(user_code or [])
        self.global_values = dict(global_values or {})
        self.gas_limit = self.global_values.get(
            GLOBAL_BLOCK_GASLIMIT, DEFAULT_BLOCK_GASLIMIT)
        self.prover_inputs = list(prover_inputs)
        self._pi_cursor = 0
        self.max_cycles = max_cycles
        self.trace = trace
        self.cpu = CpuStark(main_pc=self.kernel.main_pc)
        self.traces = Traces()
        self.image = self.kernel.image(self.user_code, self.global_values)
        self.memory = {}          # keyed (context, segment, virt)
        self.stack = []           # the CURRENT context's stack
        self.context = 0
        self.pc = self.kernel.main_pc
        self.gas = 0
        self.kern = 1
        self.clock = 0
        self.halted = False

    # ---------------------------------------------------------- helpers

    def _row(self) -> np.ndarray:
        return np.zeros(self.cpu.COLUMNS, np.uint64)

    def _mem(self, row, ch, is_read, seg, virt, value, ctx: int = 0) -> int:
        cpu = self.cpu
        if row is not None:
            row[cpu.CH_USED[ch]] = 1
            row[cpu.CH_IS_READ[ch]] = int(is_read)
            row[cpu.CH_CTX[ch]] = ctx
            row[cpu.CH_SEGMENT[ch]] = seg
            row[cpu.CH_VIRT[ch]] = virt
            for j, v in enumerate(_limbs(value)):
                row[cpu.CH_VALUE[ch][j]] = v
            self.traces.memory_ops.append(MemoryOp(
                True, self.clock * TS_STRIDE + ch + 1, is_read, ctx, seg,
                virt, value))
        if is_read:
            assert self.memory.get((ctx, seg, virt), 0) == value, \
                (ctx, seg, virt, value)
        else:
            self.memory[(ctx, seg, virt)] = value
        return value

    def _read(self, row, ch, seg, virt, ctx: int = 0) -> int:
        return self._mem(row, ch, True, seg, virt,
                         self.memory.get((ctx, seg, virt), 0), ctx=ctx)

    def _emit(self, row) -> None:
        if row is not None:
            self.traces.cpu_rows.append(row)
        self.clock += 1

    def _pop(self, row, ch) -> int:
        v = self.stack.pop()
        self._read(row, ch, SEG_STACK, len(self.stack), ctx=self.context)
        return v

    def _push(self, row, value) -> None:
        value &= WORD_MASK
        self._mem(row, 4, False, SEG_STACK, len(self.stack), value,
                  ctx=self.context)
        self.stack.append(value)

    # ------------------------------------------------------------- run

    def run(self):
        self._bootstrap()
        for _ in range(self.max_cycles):
            try:
                self.step()
            except Halted:
                self.final_stack = list(self.stack)
                self.exc_status = self.memory.get(
                    (0, SEG_GLOBAL, GLOBAL_EXC_STATUS), 0)
                return self.traces
        raise RuntimeError("program did not halt within max_cycles")

    def _bootstrap(self) -> None:
        """Write the image five entries per clock
        (cpu/bootstrap_kernel.rs, packed onto all channels)."""
        cpu = self.cpu
        for i in range(0, len(self.image), NUM_CHANNELS):
            chunk = self.image[i:i + NUM_CHANNELS]
            row = self._row() if self.trace else None
            if row is not None:
                row[cpu.IS_BOOTSTRAP] = 1
                row[cpu.CLOCK] = self.clock
            for ch, (seg, virt, value) in enumerate(chunk):
                if row is not None:
                    row[cpu.BOOT_USED[ch]] = 1
                self._mem(row, ch, False, seg, virt, value)
            self._emit(row)

    def code_ctx(self) -> int:
        """Code context: 0 in kernel mode, else the current context."""
        return 0 if self.kern else self.context

    def step(self) -> None:
        cpu = self.cpu
        pc, sp, kern = self.pc, len(self.stack), self.kern
        opcode = self.memory.get((self.code_ctx(), SEG_CODE, 2 * pc), 0)
        assert opcode < 256, f"corrupt opcode word at pc {pc}"
        nop = decode_native(opcode, bool(kern))

        # user-mode fault detection (witness/transition.rs ordering)
        if not kern:
            if self.gas > self.gas_limit:
                return self._exception(EXC_OUT_OF_GAS)
            if not user_opcode_is_valid(opcode):
                return self._exception(EXC_INVALID_OPCODE)
            if sp < min_stack_len(opcode):
                return self._exception(EXC_STACK_UNDERFLOW)
            grows = (nop is not None and nop.sp_delta == 1) or \
                (nop is None and opcode in SYSCALL_STACK_INCREASING)
            if sp == MAX_USER_STACK_SIZE and grows:
                return self._exception(EXC_STACK_OVERFLOW)
            if nop is not None and nop.name in ("jump", "jumpi"):
                exc = self._jump_fault(nop.name)
                if exc is not None:
                    return self._exception(exc)

        if nop is None:
            return self._syscall(opcode)

        row = self._cycle_row(opcode) if self.trace else None
        getattr(self, "_op_" + nop.name)(row, nop)
        if nop.gas is not None:
            self.gas += nop.gas
        self._emit(row)

    def _cycle_row(self, opcode: int) -> np.ndarray:
        cpu, row = self.cpu, self._row()
        row[cpu.IS_CYCLE] = 1
        row[cpu.CLOCK] = self.clock
        row[cpu.PC] = self.pc
        row[cpu.SP] = len(self.stack)
        row[cpu.GAS] = self.gas
        row[cpu.IS_KERNEL] = self.kern
        row[cpu.CONTEXT] = self.context
        for i in range(8):
            row[cpu.OPCODE_BITS[i]] = (opcode >> i) & 1
        if not self.kern:
            row[cpu.SP_BOUNDS_AUX] = _inv(
                len(self.stack) - (MAX_USER_STACK_SIZE + 1))
        self._read(row, 0, SEG_CODE, 2 * self.pc, ctx=self.code_ctx())
        return row

    def _flag(self, row, name) -> None:
        if row is not None:
            row[self.cpu.OP[name]] = 1

    # ------------------------------------------------- traps

    def _jump_fault(self, name: str) -> int | None:
        """Would this user JUMP/JUMPI fault? (jumps.rs:55)"""
        dst = self.stack[-1]
        cond = self.stack[-2] if name == "jumpi" else 1
        if cond == 0:
            return None
        if dst >= U32 or self.memory.get(
                (self.code_ctx(), SEG_JUMPDEST, dst), 0) != 1:
            return EXC_INVALID_JUMP if name == "jump" else EXC_INVALID_JUMPI
        return None

    def _trap(self, row, slot: int, saved_pc: int) -> None:
        handler = self._read(row, 1, SEG_JUMPTABLE, slot)
        trap = saved_pc | (self.kern << 32) | (self.gas << 192)
        self._push(row, trap)
        self._emit(row)
        self.pc, self.kern, self.gas = handler, 1, 0

    def _syscall(self, opcode: int) -> None:
        row = self._cycle_row(opcode) if self.trace else None
        self._flag(row, "syscall")
        self._trap(row, opcode, self.pc + 1)

    def _exception(self, code: int) -> None:
        row = self._cycle_row(self.memory.get(
            (self.code_ctx(), SEG_CODE, 2 * self.pc), 0)) \
            if self.trace else None
        self._flag(row, "exception")
        if row is not None:
            for i in range(3):
                row[self.cpu.EXC_BITS[i]] = (code >> i) & 1
        self._trap(row, 256 + code, self.pc)

    # ------------------------------------------------- native ops

    def _op_halt(self, row, nop) -> None:
        self._flag(row, "halt")
        self._emit(row)
        raise Halted

    def _binop(self, row, nop, result, log=None) -> None:
        self._flag(row, nop.name)
        a = self._pop(row, 1)
        b = self._pop(row, 2)
        r = result(a, b)
        if log is not None:
            log(a, b)
        self._push(row, r)
        self.pc += 1

    def _op_arith2(self, row, nop) -> None:
        op = Operation(nop.name, 0, 0)

        def res(a, b):
            nonlocal op
            op = Operation(nop.name, a, b)
            return op.result(256)
        self._binop(row, nop, res,
                    lambda a, b: self.traces.arithmetic_ops.append(op))

    _op_add = _op_mul = _op_sub = _op_div = _op_mod = _op_lt = _op_gt = \
        _op_byte = _op_addfp254 = _op_mulfp254 = _op_subfp254 = _op_arith2

    def _op_addmod(self, row, nop) -> None:
        self._flag(row, nop.name)
        a, b, m = (self._pop(row, 1), self._pop(row, 2), self._pop(row, 3))
        op = Operation(nop.name, a, b, m)
        self.traces.arithmetic_ops.append(op)
        self._push(row, op.result(256))
        self.pc += 1

    _op_mulmod = _op_addmod

    def _op_and(self, row, nop) -> None:
        fn = {"and": lambda a, b: a & b, "or": lambda a, b: a | b,
              "xor": lambda a, b: a ^ b}[nop.name]
        self._binop(row, nop, fn,
                    lambda a, b: self.traces.logic_ops.append(
                        (nop.name, a, b)))

    _op_or = _op_xor = _op_and

    def _op_not(self, row, nop) -> None:
        self._flag(row, nop.name)
        a = self._pop(row, 1)
        self._push(row, a ^ WORD_MASK)
        self.pc += 1

    def _eq_aux(self, row, a: int, b: int, equal: bool) -> None:
        """diff_pinv witness (simple_logic/eq_iszero.rs:22)."""
        if row is None or equal:
            return
        la, lb = _limbs(a), _limbs(b)
        diffs = [(x - y) % P for x, y in zip(la, lb)]
        n_unequal = sum(1 for d in diffs if d)
        ninv = _inv(n_unequal)
        for j, d in enumerate(diffs):
            row[self.cpu.AUX[j]] = _inv(d) * ninv % P

    def _op_eq(self, row, nop) -> None:
        self._flag(row, nop.name)
        a = self._pop(row, 1)
        b = self._pop(row, 2)
        self._eq_aux(row, a, b, a == b)
        self._push(row, int(a == b))
        self.pc += 1

    def _op_iszero(self, row, nop) -> None:
        self._flag(row, nop.name)
        a = self._pop(row, 1)
        self._eq_aux(row, a, 0, a == 0)
        self._push(row, int(a == 0))
        self.pc += 1

    def _op_shl(self, row, nop) -> None:
        self._shift(row, nop, "mul")

    def _op_shr(self, row, nop) -> None:
        self._shift(row, nop, "div")

    def _shift(self, row, nop, lane: str) -> None:
        self._flag(row, nop.name)
        d = self._pop(row, 1)
        v = self._pop(row, 2)
        if d < U32:
            pow2 = self._read(row, 3, SEG_SHIFT, d)
        else:
            pow2 = 0
            if row is not None:
                hi = sum(_limbs(d)[1:]) % P
                row[self.cpu.AUX[0]] = _inv(hi)
        op = Operation(lane, v, pow2)
        self.traces.arithmetic_ops.append(op)
        self._push(row, op.result(256))
        self.pc += 1

    def _op_pop(self, row, nop) -> None:
        self._flag(row, nop.name)
        self._pop(row, 1)
        self.pc += 1

    def _op_jump(self, row, nop) -> None:
        self._flag(row, nop.name)
        dst = self._pop(row, 1)
        if row is not None:
            row[self.cpu.AUX[0]] = 1
        self._jumpdest_check(row, dst, should=True)
        self.pc = dst

    def _op_jumpi(self, row, nop) -> None:
        self._flag(row, nop.name)
        dst = self._pop(row, 1)
        cond = self._pop(row, 2)
        should = cond != 0
        if row is not None:
            row[self.cpu.AUX[0]] = int(should)
            row[self.cpu.AUX[1]] = _inv(sum(_limbs(cond)))
        self._jumpdest_check(row, dst, should)
        self.pc = dst if should else self.pc + 1

    def _jumpdest_check(self, row, dst: int, should: bool) -> None:
        if row is None:
            return
        if should and not self.kern:
            bit = self._read(row, 3, SEG_JUMPDEST, dst,
                             ctx=self.code_ctx())
            assert bit == 1  # faults were filtered in step()
        else:
            # unused channel (kernel jump or untaken JUMPI): the AIR
            # still binds the metadata and pins value[0] to 1; with
            # used=0 none of it reaches the memory CTL
            cpu = self.cpu
            row[cpu.CH_IS_READ[3]] = 1
            row[cpu.CH_CTX[3]] = self.code_ctx()
            row[cpu.CH_SEGMENT[3]] = SEG_JUMPDEST
            row[cpu.CH_VIRT[3]] = dst & 0xFFFFFFFF  # AIR binds dst limb0
            row[cpu.CH_VALUE[3][0]] = 1

    def _op_pc(self, row, nop) -> None:
        self._flag(row, nop.name)
        self._push(row, self.pc)
        self.pc += 1

    def _op_jumpdest(self, row, nop) -> None:
        self._flag(row, nop.name)
        self.pc += 1

    def _op_push0(self, row, nop) -> None:
        self._flag(row, nop.name)
        self._push(row, 0)
        self.pc += 1

    def _op_push(self, row, nop) -> None:
        self._flag(row, nop.name)
        imm = self._read(row, 1, SEG_CODE, 2 * self.pc + 1,
                         ctx=self.code_ctx())
        self._push(row, imm)
        self.pc += 1

    def _op_dup(self, row, nop) -> None:
        self._flag(row, nop.name)
        n = self.memory.get(
            (self.code_ctx(), SEG_CODE, 2 * self.pc), 0) & 0xF
        sp, c = len(self.stack), self.context
        v = self._read(row, 1, SEG_STACK, sp - 1 - n, ctx=c)
        assert v == self.stack[-1 - n]
        self._push(row, v)
        self.pc += 1

    def _op_swap(self, row, nop) -> None:
        self._flag(row, nop.name)
        n = self.memory.get(
            (self.code_ctx(), SEG_CODE, 2 * self.pc), 0) & 0xF
        sp, c = len(self.stack), self.context
        x = self._read(row, 1, SEG_STACK, sp - 1, ctx=c)
        y = self._read(row, 2, SEG_STACK, sp - 2 - n, ctx=c)
        self._mem(row, 3, False, SEG_STACK, sp - 2 - n, x, ctx=c)
        self._mem(row, 4, False, SEG_STACK, sp - 1, y, ctx=c)
        self.stack[-1], self.stack[-2 - n] = y, x
        self.pc += 1

    def _op_get_sp(self, row, nop) -> None:
        self._flag(row, nop.name)
        self._push(row, len(self.stack))
        self.pc += 1

    def _op_prover_input(self, row, nop) -> None:
        self._flag(row, nop.name)
        assert self._pi_cursor < len(self.prover_inputs), \
            "prover input exhausted"
        v = self.prover_inputs[self._pi_cursor]
        self._pi_cursor += 1
        self._push(row, v & WORD_MASK)
        self.pc += 1

    @staticmethod
    def _segword(word: int) -> tuple:
        """(ctx, seg) from a segment word: ctx rides limb 1
        (opcodes.py round-4 note); the AIR zeroes limbs 2+."""
        assert word < (1 << 64), "corrupt segment word"
        return word >> 32, word & 0xFFFFFFFF

    def _op_keccak_general(self, row, nop) -> None:
        from .keccak_sponge import KeccakSpongeOp, KeccakSpongeStark
        self._flag(row, nop.name)
        mctx, seg = self._segword(self._pop(row, 1))
        virt = self._pop(row, 2)
        length = self._pop(row, 3)
        data = bytes(self.memory.get((mctx, seg, virt + i), 0)
                     for i in range(length))
        ts = self.clock * TS_STRIDE + KECCAK_TS_CH
        op = KeccakSpongeOp(mctx, seg, virt, ts, data)
        self.traces.sponge_ops.append(op)
        for i, byte in enumerate(data):
            self.traces.memory_ops.append(MemoryOp(
                True, ts, True, mctx, seg, virt + i, byte))
        digest = int.from_bytes(KeccakSpongeStark().hash_of(op), "little")
        self._push(row, digest)
        self.pc += 1

    def _op_mload_general(self, row, nop) -> None:
        self._flag(row, nop.name)
        mctx, seg = self._segword(self._pop(row, 1))
        virt = self._pop(row, 2)
        v = self._read(row, 3, seg, virt, ctx=mctx)
        self._push(row, v)
        self.pc += 1

    def _op_mstore_general(self, row, nop) -> None:
        self._flag(row, nop.name)
        mctx, seg = self._segword(self._pop(row, 1))
        virt = self._pop(row, 2)
        v = self._pop(row, 3)
        self._mem(row, 4, False, seg, virt, v, ctx=mctx)
        self.pc += 1

    def _op_get_context(self, row, nop) -> None:
        self._flag(row, nop.name)
        self._push(row, self.context)
        self.pc += 1

    def _op_set_context(self, row, nop) -> None:
        """Switch contexts, swapping SP through the per-context META_SP
        slot (cpu.py SET_CONTEXT AIR; reference contextops.rs)."""
        self._flag(row, nop.name)
        new_ctx = self._pop(row, 1)
        assert new_ctx < U32, "context id must be single-limb"
        old = self.context
        self._mem(row, 2, False, SEG_CTX_META, META_SP, len(self.stack),
                  ctx=old)
        new_sp = self._read(row, 3, SEG_CTX_META, META_SP, ctx=new_ctx)
        self.context = new_ctx
        self.stack = [self.memory.get((new_ctx, SEG_STACK, i), 0)
                      for i in range(new_sp)]
        self.pc += 1

    def _op_exit_kernel(self, row, nop) -> None:
        self._flag(row, nop.name)
        w = self._pop(row, 1)
        new_kern = (w >> 32) & 0xFFFFFFFF
        assert new_kern in (0, 1) and (w >> 224) == 0, "bad exit word"
        self.pc = w & 0xFFFFFFFF
        self.kern = new_kern
        self.gas = (w >> 192) & 0xFFFFFFFF


# ---------------------------------------------------------------------
# trace assembly (generation/mod.rs:110 generate_traces)

def sponge_derived_requests(sponge, sponge_trace: np.ndarray) -> tuple:
    """The keccak-f permutation calls and rate-XOR logic requests
    implied by a sponge trace (what the sponge delegates over CTLs)."""
    perm_inputs = []
    logic_ops = []
    filt = gl64.to_canonical(
        sponge.ctl_looking_keccak_filter().eval_rows(sponge_trace))
    for r in np.nonzero(filt)[0]:
        xored = [int(sponge_trace[i, r]) for i in sponge.XORED_RATE]
        cap = [int(sponge_trace[i, r]) for i in sponge.ORIGINAL_CAPACITY]
        chunks = xored + cap
        perm_inputs.append([chunks[2 * i] | (chunks[2 * i + 1] << 32)
                            for i in range(25)])
        rate = [int(sponge_trace[i, r]) for i in sponge.ORIGINAL_RATE]
        block = [int(sponge_trace[i, r]) for i in sponge.BLOCK_BYTES]
        for i in range(sponge.num_logic_ctls()):
            a = sum(v << (32 * j)
                    for j, v in enumerate(rate[8 * i:8 * i + 8]))
            b = sum(v << (8 * j)
                    for j, v in enumerate(block[32 * i:32 * i + 32]))
            logic_ops.append(("xor", a, b))
    return perm_inputs, logic_ops


def generate_traces(sim: Simulator, include_arithmetic: bool = True,
                    min_rows: int = 16,
                    arith_limb_bits: int = 16) -> tuple:
    """Run the simulator and build every table's trace.  Table order:
    cpu, memory, logic, [arithmetic], [keccak_sponge, keccak], program
    (always last; the keccak pair is present only when the run
    hashed)."""
    t = sim.run()
    cpu = sim.cpu
    n = 1 << max(max(len(t.cpu_rows), min_rows) - 1, 0).bit_length()
    cpu_trace = np.zeros((cpu.COLUMNS, n), np.uint64)
    for i, row in enumerate(t.cpu_rows):
        cpu_trace[:, i] = row

    memory = MemoryStark()
    mem_trace = memory.generate_trace(t.memory_ops)
    logic = LogicStark(val_bits=256)
    logic_ops = list(t.logic_ops)

    sponge_pair = None
    if t.sponge_ops:
        from .keccak import KeccakStark
        from .keccak_sponge import KeccakSpongeStark
        sponge = KeccakSpongeStark()
        sponge_trace = sponge.generate_trace(t.sponge_ops,
                                             min_rows=min_rows)
        perm_inputs, sponge_logic = sponge_derived_requests(sponge,
                                                            sponge_trace)
        logic_ops += sponge_logic
        keccak = KeccakStark()
        keccak_trace = keccak.generate_trace(perm_inputs,
                                             min_rows=min_rows)
        sponge_pair = (sponge, sponge_trace, keccak, keccak_trace)

    logic_trace = logic.generate_trace(logic_ops, min_rows=min_rows)
    traces = [cpu_trace, mem_trace, logic_trace]
    starks = [cpu, memory, logic]
    if include_arithmetic:
        # limb_bits fixes the range table at 2^limb_bits rows: 16 is the
        # production width (reference arithmetic/columns.rs LIMB_BITS);
        # 8 keeps a barely-used table at 256 rows — the CTL bus is
        # limb-width-invariant (arithmetic.py ctl_data)
        arith = ArithmeticStark(val_bits=256, limb_bits=arith_limb_bits)
        traces.append(arith.generate_trace(t.arithmetic_ops))
        starks.append(arith)
    else:
        assert not t.arithmetic_ops, \
            "run used arithmetic; cannot exclude the table"
    if sponge_pair is not None:
        sponge, sponge_trace, keccak, keccak_trace = sponge_pair
        starks += [sponge, keccak]
        traces += [sponge_trace, keccak_trace]
    from .program import ProgramStark
    prog = ProgramStark()
    traces.append(prog.generate_trace(sim.image, min_rows=min_rows))
    starks.append(prog)
    return starks, traces, sim


def all_cross_table_lookups(starks: list) -> list:
    """(all_stark.rs:99) the full CTL wiring for a table list produced
    by `generate_traces`: memory bus (CPU channels + sponge byte reads),
    logic bus (CPU bitwise ops + sponge rate XORs), arithmetic bus (two
    CPU lanes: direct ops and SHL/SHR riding MUL/DIV), sponge/keccak-f
    link, CPU->sponge hash requests, and the bootstrap-image/ROM
    binding per memory channel.  Table roles are identified by type."""
    from . import memory as memmod

    idx = {type(s).__name__: i for i, s in enumerate(starks)}
    cpu = starks[idx["CpuStark"]]
    logic = starks[idx["LogicStark"]]
    arith = (starks[idx["ArithmeticStark"]]
             if "ArithmeticStark" in idx else None)
    sponge = (starks[idx["KeccakSpongeStark"]]
              if "KeccakSpongeStark" in idx else None)
    ci = idx["CpuStark"]

    mem_looking = [
        TableWithColumns(ci, tuple(cpu.ctl_looking_memory(ch)),
                         cpu.ctl_looking_memory_filter(ch))
        for ch in range(NUM_CHANNELS)]
    logic_looking = [
        TableWithColumns(ci, tuple(cpu.ctl_looking_logic()),
                         cpu.ctl_looking_logic_filter())]
    if sponge is not None:
        si = idx["KeccakSpongeStark"]
        mem_looking += [
            TableWithColumns(si, tuple(sponge.ctl_looking_memory(i)),
                             sponge.ctl_looking_memory_filter(i))
            for i in range(136)]
        logic_looking += [
            TableWithColumns(si, tuple(sponge.ctl_looking_logic(i)),
                             sponge.ctl_looking_logic_filter())
            for i in range(sponge.num_logic_ctls())]

    ctls = [
        CrossTableLookup(
            looking_tables=tuple(mem_looking),
            looked_table=TableWithColumns(
                idx["MemoryStark"], tuple(memmod.ctl_data()),
                memmod.ctl_filter())),
        CrossTableLookup(
            looking_tables=tuple(logic_looking),
            looked_table=TableWithColumns(
                idx["LogicStark"], tuple(logic.ctl_data()),
                logic.ctl_filter())),
    ]
    if arith is not None:
        ctls.append(CrossTableLookup(
            looking_tables=(
                TableWithColumns(ci, tuple(cpu.ctl_looking_arithmetic()),
                                 cpu.ctl_looking_arithmetic_filter()),
                TableWithColumns(
                    ci, tuple(cpu.ctl_looking_arithmetic_shift()),
                    cpu.ctl_looking_arithmetic_shift_filter())),
            looked_table=TableWithColumns(
                idx["ArithmeticStark"], tuple(arith.ctl_data()),
                arith.ctl_filter())))
    if sponge is not None:
        keccak = starks[idx["KeccakStark"]]
        ctls.append(CrossTableLookup(
            looking_tables=(TableWithColumns(
                idx["KeccakSpongeStark"],
                tuple(sponge.ctl_looking_keccak()),
                sponge.ctl_looking_keccak_filter()),),
            looked_table=TableWithColumns(
                idx["KeccakStark"], tuple(keccak.ctl_data()),
                keccak.ctl_filter())))
        ctls.append(CrossTableLookup(
            looking_tables=(TableWithColumns(
                ci, tuple(cpu.ctl_looking_keccak_sponge()),
                cpu.ctl_looking_keccak_sponge_filter()),),
            looked_table=TableWithColumns(
                idx["KeccakSpongeStark"],
                tuple(sponge.ctl_looked_data()),
                sponge.ctl_looked_filter())))
    prog = starks[idx["ProgramStark"]]
    ctls.append(CrossTableLookup(
        looking_tables=tuple(
            TableWithColumns(ci, tuple(cpu.ctl_looking_program(ch)),
                             cpu.ctl_looking_program_filter(ch))
            for ch in range(NUM_CHANNELS)),
        looked_table=TableWithColumns(
            idx["ProgramStark"], tuple(prog.ctl_data()),
            prog.ctl_filter())))
    return ctls


def prove_program(user_code: list | None = None, kernel=None,
                  global_values: dict | None = None, prover_inputs=(),
                  config: StarkConfig = None,
                  include_arithmetic: bool = True,
                  max_cycles: int = 4_000_000,
                  arith_limb_bits: int = 16,
                  timing: TimingTree | None = None, device=None):
    """End-to-end: simulate, build traces, joint multi-table proof
    (evm/src/prover.rs:45 prove).  The prove runs on ``device`` (None
    means CUDA); ``timing`` gets a "simulate + generate traces" scope and
    a "prove" scope with the multi-table prover's phases under it."""
    device = resolve_device(device)
    config = config or StarkConfig.standard_fast_config()
    timing = timing if timing is not None else TimingTree("prove_program",
                                                           device)
    with timing.scope("simulate + generate traces"):
        sim = Simulator(user_code, kernel=kernel, global_values=global_values,
                        prover_inputs=prover_inputs, max_cycles=max_cycles)
        starks, traces, sim = generate_traces(
            sim, include_arithmetic, arith_limb_bits=arith_limb_bits)
        ctls = all_cross_table_lookups(starks)
    with timing.scope("prove") as prove_timing:
        proof = prove_multi_table(starks, ctls, config, traces,
                                  timing=prove_timing, device=device)
    return proof, starks, ctls, sim


def verify_program_proof(starks: list, ctls: list, proof,
                         config: StarkConfig = None,
                         user_code: list = None, kernel=None,
                         global_values: dict | None = None,
                         device=None) -> None:
    """(evm/src/verifier.rs:29).  When the public inputs (kernel, user
    code, global metadata) are given, the program ROM's trace
    commitment is recomputed from them (on ``device``; None means CUDA)
    and pinned against the proof, binding the executed image to public
    data (program.py)."""
    config = config or StarkConfig.standard_fast_config()
    verify_multi_table(starks, ctls, proof, config)
    if user_code is not None or global_values is not None \
            or kernel is not None:
        from ..field.goldilocks import GF
        from ..fri.oracle import PolynomialBatch
        from .program import ProgramStark
        device = resolve_device(device)
        prog = starks[-1]
        assert isinstance(prog, ProgramStark), "program table must be last"
        kernel = kernel or KERNEL
        image = kernel.image(user_code, global_values)
        n = 1 << proof.stark_proofs[-1].degree_bits
        trace = prog.generate_trace(image, min_rows=n)
        assert trace.shape[-1] == n, "program trace size mismatch"
        expect = PolynomialBatch.from_values(
            GF.from_u64(trace, device), config.fri_config.rate_bits, False,
            config.fri_config.cap_height)
        assert expect.merkle_tree.cap == proof.stark_proofs[-1].trace_cap, \
            "program ROM commitment does not match the public image"
