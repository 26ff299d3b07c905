"""CPU STARK: the full EVM-style machine driving the zkEVM table set
(twin of reference evm/src/cpu/cpu_stark.rs and the cpu/ sub-modules).

Architecture mirrors the reference.  Rows are *bootstrap* rows, which
write the kernel image (code, jumptables, shift table, jumpdest bits,
global metadata) into memory (cpu/bootstrap_kernel.rs), or *cycle*
rows, each executing one instruction; the opcode is committed as 8 bits
and decoded into per-block one-hot flags (cpu/decode.rs:25), with
kernel-only blocks gated by the IS_KERNEL flag.  Any opcode without an
available native block executes as a SYSCALL row: it saves
(pc+1, kernel_flag, gas) in one stack word, jumps to the handler read
from the kernel's syscall jumptable, and enters kernel mode
(cpu/syscalls.rs); EXIT_KERNEL restores the saved state (cpu/jumps.rs).
User-mode faults trap likewise through the exception jumptable
(cpu/exceptions.rs), and the kernel handler must re-verify the fault in
software — faking an exception lands in PANIC, an infinite kernel loop
that can never reach the mandatory final HALT row, making the proof
impossible (decode.rs:20 note, control_flow.rs:74).

All data movement goes through five memory channels CTL'd to the memory
table (cpu/membus.rs): channel 0 fetches the opcode word, channels 1..3
pop operands at STACK[sp-1..sp-3] (PUSH reads its immediate word via
channel 1; DUP/SWAP address deeper slots from the opcode's low bits,
cpu/dup_swap.rs), channel 4 pushes or stores.  ALU work is delegated
over CTLs to the arithmetic and logic tables; SHL/SHR read 2^d from the
bootstrapped shift table and ride the MUL/DIV lanes of the arithmetic
CTL (cpu/shift.rs — closing that file's "must connect" TODO); EQ/ISZERO
are proven in-row with a dot-product inverse witness
(cpu/simple_logic/eq_iszero.rs:38); JUMP/JUMPI check a bootstrapped
jumpdest-bit segment (cpu/jumps.rs:55).  Gas is accumulated with
per-block constant costs (cpu/gas.rs:20) and the user stack is bounded
by an inverse witness at 1024 (cpu/stack_bounds.rs).

Differences from the reference, by design (see opcodes.py): word-
granular code (2 words per instruction), explicit fetch on channel 0,
a kernel-only native HALT (STOP in kernel mode) instead of the two-pc
halt loop, and bootstrap rows that write five image words per row,
each CTL'd against the public program ROM (program.py) instead of the
in-kernel code-hash chain (bootstrap_kernel.rs:60).

Execution contexts (round 4; reference cpu/contextops.rs +
memory/segments.rs per-context segments): every memory access carries
a context; per-context segments (stack, main, bytes, calldata,
returndata, ctx metadata, runtime code for ctx > 0) use the CONTEXT
register, shared segments (kernel code/jumptables/shift/global/trie/
rlp) use context 0, and code fetches use the code context (0 in kernel
mode).  GET_CONTEXT/SET_CONTEXT are kernel-only natives; SET_CONTEXT
swaps SP through the per-context META_SP slot, so the kernel enters a
fresh context by pre-seeding its stack cells + META_SP and popping the
context id (call.asm %enter_new_ctx equivalent).

Word = 256 bits = 8 x u32 limbs.  Memory timestamps stride by
NUM_CHANNELS+1 per clock with slot 0 reserved for the keccak sponge's
byte reads (see round-1 soundness note in git history).
"""

from __future__ import annotations

from ..field import gl64
from ..stark.ctl import Column
from ..stark.stark import Stark
from .arithmetic import ALL_OPS as ARITH_TABLE_OPS
from .opcodes import ALL_FLAGS, BY_NAME, MAX_USER_STACK_SIZE, NATIVE_OPS

P = gl64.ORDER_INT

WORD_LIMBS = 8
NUM_CHANNELS = 5
NUM_GP = 4          # channels 1..4

# memory segments (twin of memory/segments.rs, reduced set)
SEG_CODE = 1
SEG_STACK = 2
SEG_MAIN = 3        # word-granular scratch memory
SEG_BYTES = 4       # byte-granular region (keccak preimages, RLP buffers)
SEG_JUMPTABLE = 5   # syscall handlers at [opcode], exceptions at 256+code
SEG_SHIFT = 6       # 2^i mod 2^256 at [i], i in 0..255 (Segment::ShiftTable)
SEG_JUMPDEST = 7    # 1 at [pc] iff code word at 2pc is JUMPDEST (0x5b)
SEG_GLOBAL = 8      # global metadata (proof.rs BlockMetadata + trie roots)
SEG_TRIE = 9        # word-granular MPT node data (Segment::TrieData)
SEG_RLP = 10        # byte-granular RLP scratch (Segment::RlpRaw)
SEG_CALLDATA = 11   # per-context calldata bytes (Segment::Calldata)
SEG_RETURNDATA = 12  # per-context returndata bytes (Segment::Returndata)
SEG_CTX_META = 13   # per-context metadata (Segment::ContextMetadata)
SEG_JOURNAL = 14    # state-change journal entries (journal/journal.asm)
SEG_LOGS = 15       # event-log records (logs.asm; Segment::Logs + TxnBloom)
SEG_ACCESS = 16     # EIP-2929 warm sets (access.asm; Segment::AccessedAddresses
                    # + AccessedStorageKeys, flattened into one segment)

# SEG_CTX_META slots (reference memory/segments.rs ContextMetadata)
META_SP = 0          # saved stack length (SET_CONTEXT swaps SP through it)
META_PARENT_CTX = 1
META_PARENT_PC = 2
META_CALLDATA_SIZE = 3
META_RETURNDATA_SIZE = 4
META_ADDRESS = 5
META_CALLER = 6
META_CALLVALUE = 7
META_RETOFF = 8      # parent-memory return-copy offset
META_RETSIZE = 9
META_GAS_START = 10  # parent gas_used at entry (for sub-context metering)
META_STATIC = 11     # STATICCALL flag (reference CTX_METADATA_STATIC)
META_ACCT_VPTR = 12  # executing account's state-trie value pointer
META_CKPT = 13       # journal length at frame entry (revert target)
META_MSIZE = 14      # frame memory size in 32-byte words (gas.asm)
META_GASLIMIT = 15   # frame gas limit (63/64-forwarded, gas.asm)

EXC_JUMPTABLE_BASE = 256    # exception handlers start here in SEG_JUMPTABLE

# per-clock timestamp slots: sponge reads at slot 0, channels at 1..5
TS_STRIDE = NUM_CHANNELS + 1
KECCAK_TS_CH = 0

U32M = (1 << 32) - 1

# arithmetic-table lane carrying each CPU flag (cpu_stark.rs:82
# ctl_arithmetic_rows; shl/shr ride mul/div per shift.rs:57)
ARITH_LANES = {op: op for op in
               ("add", "mul", "sub", "div", "mod", "addmod", "mulmod",
                "addfp254", "mulfp254", "subfp254", "lt", "gt", "byte")}
SHIFT_LANES = {"shl": "mul", "shr": "div"}
LOGIC_OPS = ("and", "or", "xor")


class CpuStark(Stark):
    """`main_pc` is the kernel entry point (control_flow.rs:62
    get_start_pc) — part of the public kernel, baked into the
    constraints the verifier evaluates."""

    PUBLIC_INPUTS = 0

    def __init__(self, main_pc: int = 0):
        self.main_pc = main_pc
        c = iter(range(10**6))
        self.IS_BOOTSTRAP = next(c)
        self.IS_CYCLE = next(c)
        self.CLOCK = next(c)
        self.PC = next(c)
        self.SP = next(c)
        self.GAS = next(c)
        self.IS_KERNEL = next(c)
        # current execution context (contextops.rs); per-context
        # segments (stack, main, bytes, calldata, returndata, ctx
        # metadata, runtime code) are addressed through it
        self.CONTEXT = next(c)
        self.OPCODE_BITS = [next(c) for _ in range(8)]
        self.OP = {name: next(c) for name in ALL_FLAGS}
        self.EXC_BITS = [next(c) for _ in range(3)]
        self.SP_BOUNDS_AUX = next(c)
        # shared per-op aux: eq/iszero diff_pinv[8]; jumps use AUX[0] as
        # should_jump and AUX[1] as cond_sum_pinv; shifts use AUX[0] as
        # the high-limb-sum inverse (columns are shareable because the
        # op flags are one-hot)
        self.AUX = [next(c) for _ in range(8)]
        self.BOOT_USED = [next(c) for _ in range(NUM_CHANNELS)]
        self.CH_USED, self.CH_IS_READ, self.CH_CTX, self.CH_SEGMENT, \
            self.CH_VIRT, self.CH_VALUE = [], [], [], [], [], []
        for _ in range(NUM_CHANNELS):
            self.CH_USED.append(next(c))
            self.CH_IS_READ.append(next(c))
            self.CH_CTX.append(next(c))
            self.CH_SEGMENT.append(next(c))
            self.CH_VIRT.append(next(c))
            self.CH_VALUE.append([next(c) for _ in range(WORD_LIMBS)])
        self.COLUMNS = next(c)

    # ------------------------------------------------------------------
    # CTL exports

    def ctl_looking_memory(self, ch: int) -> list:
        """Memory-bus row for channel ch: (is_read, ctx, seg, virt,
        value8, timestamp = clock*TS_STRIDE + ch + 1) (membus.rs)."""
        ts = Column.linear([(self.CLOCK, TS_STRIDE)], constant=ch + 1)
        return [Column.single(self.CH_IS_READ[ch]),
                Column.single(self.CH_CTX[ch]),
                Column.single(self.CH_SEGMENT[ch]),
                Column.single(self.CH_VIRT[ch])] + \
            Column.singles(self.CH_VALUE[ch]) + [ts]

    def ctl_looking_memory_filter(self, ch: int) -> Column:
        return Column.single(self.CH_USED[ch])

    def _arith_flag_cols(self, lanes: dict) -> list:
        """Arithmetic-table flag vector implied by this row's op flags,
        with CPU op `k` riding table lane `lanes[k]`."""
        by_lane = {}
        for cpu_op, lane in lanes.items():
            by_lane.setdefault(lane, []).append(self.OP[cpu_op])
        return [Column.sum_cols(by_lane[lane]) if lane in by_lane
                else Column.zero() for lane in ARITH_TABLE_OPS]

    def ctl_looking_arithmetic(self) -> list:
        """(cpu_stark.rs:82 ctl_arithmetic_rows) — flag per table op,
        then in0 (top of stack), in1, in2, out as 8 u32 limbs each."""
        res = self._arith_flag_cols(ARITH_LANES)
        res += Column.singles(self.CH_VALUE[1])
        res += Column.singles(self.CH_VALUE[2])
        res += Column.singles(self.CH_VALUE[3])
        res += Column.singles(self.CH_VALUE[4])
        return res

    def ctl_looking_arithmetic_filter(self) -> Column:
        return Column.sum_cols(self.OP[k] for k in ARITH_LANES)

    def ctl_looking_arithmetic_shift(self) -> list:
        """Second arithmetic lane for SHL/SHR: value * / div 2^d, with
        the power read from the shift table (shift.rs:57)."""
        res = self._arith_flag_cols(SHIFT_LANES)
        res += Column.singles(self.CH_VALUE[2])   # in0 = shifted value
        res += Column.singles(self.CH_VALUE[3])   # in1 = 2^displacement
        res += [Column.zero()] * WORD_LIMBS
        res += Column.singles(self.CH_VALUE[4])
        return res

    def ctl_looking_arithmetic_shift_filter(self) -> Column:
        return Column.sum_cols(self.OP[k] for k in SHIFT_LANES)

    def ctl_looking_logic(self) -> list:
        """(cpu_stark.rs:74 ctl_data_logic: and/or/xor flags, in0, in1,
        result)."""
        res = [Column.single(self.OP[k]) for k in LOGIC_OPS]
        res += Column.singles(self.CH_VALUE[1])
        res += Column.singles(self.CH_VALUE[2])
        res += Column.singles(self.CH_VALUE[4])
        return res

    def ctl_looking_logic_filter(self) -> Column:
        return Column.sum_cols(self.OP[k] for k in LOGIC_OPS)

    def ctl_looking_program(self, ch: int) -> list:
        """Bootstrap writes against the program ROM: (segment, virt,
        word8) per channel (program.py; replaces the reference's
        bootstrap code-hash chain, bootstrap_kernel.rs:60)."""
        return Column.singles([self.CH_SEGMENT[ch], self.CH_VIRT[ch]]
                              + self.CH_VALUE[ch])

    def ctl_looking_program_filter(self, ch: int) -> Column:
        return Column.single(self.BOOT_USED[ch])

    def ctl_looking_keccak_sponge(self) -> list:
        """KECCAK_GENERAL against the sponge table's looked row:
        (ctx, segment, virt, len, timestamp, digest8)
        (cpu_stark.rs:25 ctl_data_keccak_sponge).  The context rides
        limb 1 of the segment word (opcodes.py round-4 note)."""
        return [Column.single(self.CH_VALUE[1][1]),   # context
                Column.single(self.CH_VALUE[1][0]),   # segment
                Column.single(self.CH_VALUE[2][0]),   # virt
                Column.single(self.CH_VALUE[3][0]),   # len
                Column.linear([(self.CLOCK, TS_STRIDE)],
                              constant=KECCAK_TS_CH)] + \
            Column.singles(self.CH_VALUE[4])

    def ctl_looking_keccak_sponge_filter(self) -> Column:
        return Column.single(self.OP["keccak_general"])

    # ------------------------------------------------------------------
    # constraints

    def eval_generic(self, ctx, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = ctx.one()

        boot, cyc = lv[self.IS_BOOTSTRAP], lv[self.IS_CYCLE]
        nboot, ncyc = nv[self.IS_BOOTSTRAP], nv[self.IS_CYCLE]
        kernel = lv[self.IS_KERNEL]
        pc, sp, gas = lv[self.PC], lv[self.SP], lv[self.GAS]
        ectx = lv[self.CONTEXT]
        # per-context segments use the current context; code (and the
        # jumpdest bits derived from it) use the CODE context: 0 in
        # kernel mode, the current context in user mode (membus.rs
        # code_context)
        code_ctx = (one - kernel) * ectx
        op = {name: lv[self.OP[name]] for name in ALL_FLAGS}

        # ---- row types ------------------------------------------------
        yield_constr.constraint(boot * (boot - one))
        yield_constr.constraint(cyc * (cyc - one))
        yield_constr.constraint(boot * cyc)
        live = boot + cyc
        nlive = nboot + ncyc
        yield_constr.constraint_first_row(live - one)
        # bootstrap* cycle* padding* ordering
        yield_constr.constraint_transition(nboot * (one - boot))
        yield_constr.constraint_transition((one - live) * nlive)
        # execution, once started, only stops after a HALT row
        halt = op["halt"]
        yield_constr.constraint_transition(cyc * (one - ncyc) * (cyc - halt))
        yield_constr.constraint_transition(halt * ncyc)

        # clock starts at 0 and increments while live
        yield_constr.constraint_first_row(lv[self.CLOCK])
        yield_constr.constraint_transition(
            nlive * (nv[self.CLOCK] - lv[self.CLOCK] - one))

        # ---- decode (decode.rs:131 eval_packed_generic) ---------------
        yield_constr.constraint(cyc * kernel * (kernel - one))
        bits = [lv[b] for b in self.OPCODE_BITS]
        for b in bits:
            yield_constr.constraint(cyc * b * (b - one))
        flags = [op[name] for name in ALL_FLAGS]
        for f in flags:
            yield_constr.constraint(f * (f - one))
        flag_sum = flags[0]
        for f in flags[1:]:
            flag_sum = flag_sum + f
        # exactly one op per cycle row (and none elsewhere)
        yield_constr.constraint(flag_sum - cyc)
        # block classification: flag => opcode bits match + mode available
        for nop in NATIVE_OPS:
            mismatch = ctx.zero()
            for i in range(nop.block_bits, 8):
                want = (nop.opcode >> i) & 1
                mismatch = mismatch + (one - bits[i] if want else bits[i])
            if nop.kernel_only:
                mismatch = mismatch + (one - kernel)
            yield_constr.constraint(op[nop.name] * mismatch)
        # exceptions fire only in user mode (exceptions.rs:32)
        yield_constr.constraint(op["exception"] * kernel)
        for b in self.EXC_BITS:
            yield_constr.constraint(
                op["exception"] * lv[b] * (lv[b] - one))

        # opcode binding: fetched word limb0 == sum(bit_i 2^i), rest 0
        opcode = ctx.zero()
        for i, b in enumerate(bits):
            opcode = opcode + b * ctx.constant(1 << i)
        yield_constr.constraint(cyc * (lv[self.CH_VALUE[0][0]] - opcode))
        for j in range(1, WORD_LIMBS):
            yield_constr.constraint(cyc * lv[self.CH_VALUE[0][j]])

        # ---- channel plumbing -----------------------------------------
        for ch in range(NUM_CHANNELS):
            used = lv[self.CH_USED[ch]]
            bu = lv[self.BOOT_USED[ch]]
            yield_constr.constraint(used * (used - one))
            yield_constr.constraint((one - live) * used)       # padding
            yield_constr.constraint(bu * (bu - one))
            yield_constr.constraint((one - boot) * bu)
            yield_constr.constraint(boot * (used - bu))
            yield_constr.constraint(bu * lv[self.CH_IS_READ[ch]])  # writes
            # bootstrap writes land in context 0
            yield_constr.constraint(boot * lv[self.CH_CTX[ch]])

        # fetch: ch0 = CODE[2pc] on cycle rows, in the code context
        self._channel(ctx, yield_constr, lv, 0, cyc, is_read=one,
                      segment=SEG_CODE, virt=pc + pc, context=code_ctx)
        yield_constr.constraint(cyc * (lv[self.CH_USED[0]] - one))

        # ---- per-op channel shapes ------------------------------------
        val = self.CH_VALUE

        def ch_used(chn, *terms):
            """channel `chn`.used == sum of flag terms on cycle rows"""
            s = ctx.zero()
            for t in terms:
                s = s + t
            yield_constr.constraint(cyc * (lv[self.CH_USED[chn]] - s))

        pops1, pops2, pops3 = [], [], []
        pushers = []   # (flag, write-index expr) for channel 4
        for nop in NATIVE_OPS:
            if nop.name in ("push", "dup", "swap"):
                continue
            f = op[nop.name]
            if nop.pops >= 1:
                pops1.append((f, nop))
            if nop.pops >= 2:
                pops2.append((f, nop))
            if nop.pops >= 3:
                pops3.append((f, nop))
            if nop.pushes:
                pushers.append((f, sp - ctx.constant(nop.pops)
                                if nop.pops else sp))
        for f in (op["syscall"], op["exception"]):
            pushers.append((f, sp))

        # stack pops on channels 1..3 (stack.rs:41 STACK_BEHAVIORS) — the
        # stack is per-context
        for depth, group in ((1, pops1), (2, pops2), (3, pops3)):
            filt = ctx.zero()
            for f, _ in group:
                filt = filt + f
            self._channel(ctx, yield_constr, lv, depth, filt, is_read=one,
                          segment=SEG_STACK, virt=sp - ctx.constant(depth),
                          context=ectx)

        # pushes / writes on channel 4
        for f, virt in pushers:
            self._channel(ctx, yield_constr, lv, 4, f,
                          is_read=ctx.zero(), segment=SEG_STACK, virt=virt,
                          context=ectx)

        # PUSH: ch1 reads the immediate word CODE[2pc+1], ch4 pushes it
        f = op["push"]
        self._channel(ctx, yield_constr, lv, 1, f, is_read=one,
                      segment=SEG_CODE, virt=pc + pc + one,
                      context=code_ctx)
        self._channel(ctx, yield_constr, lv, 4, f, is_read=ctx.zero(),
                      segment=SEG_STACK, virt=sp, context=ectx)
        self._equal_values(yield_constr, lv, f, 1, 4)

        # DUP n / SWAP n: n = low 4 opcode bits (dup_swap.rs:105)
        n_bits = bits[0]
        for i in range(1, 4):
            n_bits = n_bits + bits[i] * ctx.constant(1 << i)
        f = op["dup"]
        self._channel(ctx, yield_constr, lv, 1, f, is_read=one,
                      segment=SEG_STACK, virt=sp - one - n_bits,
                      context=ectx)
        self._channel(ctx, yield_constr, lv, 4, f, is_read=ctx.zero(),
                      segment=SEG_STACK, virt=sp, context=ectx)
        self._equal_values(yield_constr, lv, f, 1, 4)
        f = op["swap"]
        self._channel(ctx, yield_constr, lv, 1, f, is_read=one,
                      segment=SEG_STACK, virt=sp - one, context=ectx)
        self._channel(ctx, yield_constr, lv, 2, f, is_read=one,
                      segment=SEG_STACK, virt=sp - one - one - n_bits,
                      context=ectx)
        self._channel(ctx, yield_constr, lv, 3, f, is_read=ctx.zero(),
                      segment=SEG_STACK, virt=sp - one - one - n_bits,
                      context=ectx)
        self._channel(ctx, yield_constr, lv, 4, f, is_read=ctx.zero(),
                      segment=SEG_STACK, virt=sp - one, context=ectx)
        self._equal_values(yield_constr, lv, f, 1, 3)
        self._equal_values(yield_constr, lv, f, 2, 4)

        # MLOAD_GENERAL: ch3 reads (ctx=ch1.v1, seg=ch1.v0, virt=ch2.v0),
        # ch4 pushes (the context rides limb 1 of the segment word)
        f = op["mload_general"]
        self._channel(ctx, yield_constr, lv, 3, f, is_read=one,
                      segment=None, seg_expr=val[1][0],
                      virt=lv[val[2][0]], context=lv[val[1][1]])
        self._equal_values(yield_constr, lv, f, 3, 4)
        # MSTORE_GENERAL: ch4 writes value=ch3 at (ch1.v1, ch1.v0, ch2.v0)
        f = op["mstore_general"]
        self._channel(ctx, yield_constr, lv, 4, f, is_read=ctx.zero(),
                      segment=None, seg_expr=val[1][0],
                      virt=lv[val[2][0]], context=lv[val[1][1]])
        self._equal_values(yield_constr, lv, f, 3, 4)
        # general-memory operands: segword = ctx<<32 | seg (limbs 2+
        # zero), virt/len single-limb
        genmem = (op["mload_general"] + op["mstore_general"]
                  + op["keccak_general"])
        for j in range(1, WORD_LIMBS):
            if j >= 2:
                yield_constr.constraint(genmem * lv[val[1][j]])
            yield_constr.constraint(genmem * lv[val[2][j]])
            yield_constr.constraint(op["keccak_general"] * lv[val[3][j]])

        # binary ops riding the arithmetic CTL leave channel 3 unused;
        # pin its limbs to the table's input2 = 0 so the bus rows match
        f = ctx.zero()
        for name, lane in ARITH_LANES.items():
            if BY_NAME[name].pops == 2:
                f = f + op[name]
        for j in range(WORD_LIMBS):
            yield_constr.constraint(f * lv[val[3][j]])

        # PC / PUSH0 / GET_SP / GET_CONTEXT / PROVER_INPUT pushed values
        self._pushed_scalar(ctx, yield_constr, lv, op["pc"], pc)
        self._pushed_scalar(ctx, yield_constr, lv, op["push0"], ctx.zero())
        self._pushed_scalar(ctx, yield_constr, lv, op["get_sp"], sp)
        self._pushed_scalar(ctx, yield_constr, lv, op["get_context"], ectx)
        # prover_input: value unconstrained (generation/prover_input.rs)

        # SET_CONTEXT (contextops.rs sys_set_context redesign): ch1 pops
        # the new context (single-limb); ch2 saves the post-pop SP into
        # the OLD context's metadata; ch3 restores SP from the NEW
        # context's metadata (the kernel seeds it when creating a
        # context); transitions below set CONTEXT'/SP' from ch1/ch3.
        f = op["set_context"]
        for j in range(1, WORD_LIMBS):
            yield_constr.constraint(f * lv[val[1][j]])
        self._channel(ctx, yield_constr, lv, 2, f, is_read=ctx.zero(),
                      segment=SEG_CTX_META, virt=ctx.constant(META_SP),
                      context=ectx)
        yield_constr.constraint(f * (lv[val[2][0]] - (sp - one)))
        for j in range(1, WORD_LIMBS):
            yield_constr.constraint(f * lv[val[2][j]])
        self._channel(ctx, yield_constr, lv, 3, f, is_read=one,
                      segment=SEG_CTX_META, virt=ctx.constant(META_SP),
                      context=lv[val[1][0]])
        yield_constr.constraint_transition(
            f * (nv[self.CONTEXT] - lv[val[1][0]]))
        yield_constr.constraint_transition(f * (nv[self.SP] - lv[val[3][0]]))

        # NOT: out = ~in, limbwise (simple_logic/not.rs)
        f = op["not"]
        for j in range(WORD_LIMBS):
            yield_constr.constraint(
                f * (lv[val[4][j]] + lv[val[1][j]] - ctx.constant(U32M)))

        # EQ / ISZERO via diff dot diff_pinv == 1 - equal
        # (simple_logic/eq_iszero.rs:51)
        for f, rhs in ((op["eq"], val[2]), (op["iszero"], None)):
            out0 = lv[val[4][0]]
            yield_constr.constraint(f * out0 * (out0 - one))
            for j in range(1, WORD_LIMBS):
                yield_constr.constraint(f * lv[val[4][j]])
            dot = ctx.zero()
            for j in range(WORD_LIMBS):
                diff = (lv[val[1][j]] - lv[rhs[j]]) if rhs is not None \
                    else lv[val[1][j]]
                yield_constr.constraint(f * out0 * diff)
                dot = dot + diff * lv[self.AUX[j]]
            yield_constr.constraint(f * (dot - (one - out0)))

        # SHL/SHR: ch3 reads 2^d from the shift table when d < 2^32,
        # else the factor is pinned to 0 (shift.rs:26)
        f = op["shl"] + op["shr"]
        hi_sum = ctx.zero()
        for j in range(1, WORD_LIMBS):
            hi_sum = hi_sum + lv[val[1][j]]
        sh_used = lv[self.CH_USED[3]]
        yield_constr.constraint(f * hi_sum * sh_used)
        yield_constr.constraint(
            f * (hi_sum * lv[self.AUX[0]] - (one - sh_used)))
        self._channel(ctx, yield_constr, lv, 3, f * sh_used, is_read=one,
                      segment=SEG_SHIFT, virt=lv[val[1][0]], skip_used=True)
        yield_constr.constraint(f * lv[self.CH_CTX[3]])  # shift table: ctx 0
        for j in range(WORD_LIMBS):
            yield_constr.constraint(f * (one - sh_used) * lv[val[3][j]])

        # ---- jumps (jumps.rs:55 eval_packed_jump_jumpi) ---------------
        jf = op["jump"] + op["jumpi"]
        should_jump, cond_pinv = lv[self.AUX[0]], lv[self.AUX[1]]
        dst = val[1]
        yield_constr.constraint(op["jump"] * (should_jump - one))
        cond_sum = ctx.zero()
        for j in range(WORD_LIMBS):
            cond_sum = cond_sum + lv[val[2][j]]
        f = op["jumpi"]
        yield_constr.constraint(f * should_jump * (should_jump - one))
        yield_constr.constraint(f * (one - should_jump) * cond_sum)
        yield_constr.constraint(f * (cond_pinv * cond_sum - should_jump))
        # jumping => high limbs of dst are 0
        dst_hi = ctx.zero()
        for j in range(1, WORD_LIMBS):
            dst_hi = dst_hi + lv[dst[j]]
        yield_constr.constraint(jf * should_jump * dst_hi)
        # jumpdest bit read on ch3, only when jumping in user mode
        yield_constr.constraint(
            jf * (lv[self.CH_USED[3]] - should_jump * (one - kernel)))
        self._channel(ctx, yield_constr, lv, 3, jf, is_read=one,
                      segment=SEG_JUMPDEST, virt=lv[dst[0]],
                      skip_used=True, context=code_ctx)
        yield_constr.constraint(jf * (lv[val[3][0]] - one))
        for j in range(1, WORD_LIMBS):
            yield_constr.constraint(jf * lv[val[3][j]])
        yield_constr.constraint_transition(
            jf * should_jump * (nv[self.PC] - lv[dst[0]]))
        # no ncyc factor: only HALT may end execution, so an untaken
        # jump always has a successor cycle row (keeps degree <= 3)
        yield_constr.constraint_transition(
            jf * (one - should_jump) * (nv[self.PC] - pc - one))
        yield_constr.constraint_transition(jf * (nv[self.IS_KERNEL] - kernel))

        # ---- syscall / exception (syscalls.rs, exceptions.rs) ---------
        exc_code = ctx.zero()
        for i, b in enumerate(self.EXC_BITS):
            exc_code = exc_code + lv[b] * ctx.constant(1 << i)
        for f, slot, saved_pc in (
                (op["syscall"], opcode, pc + one),
                (op["exception"], exc_code + ctx.constant(EXC_JUMPTABLE_BASE),
                 pc)):
            self._channel(ctx, yield_constr, lv, 1, f, is_read=one,
                          segment=SEG_JUMPTABLE, virt=slot)
            # saved state word: (pc', kernel_flag, 0, 0, 0, 0, gas, 0)
            yield_constr.constraint(f * (lv[val[4][0]] - saved_pc))
            yield_constr.constraint(f * (lv[val[4][1]] - kernel))
            for j in (2, 3, 4, 5, 7):
                yield_constr.constraint(f * lv[val[4][j]])
            yield_constr.constraint(f * (lv[val[4][6]] - gas))
            # handler address is one limb; jump there in kernel mode
            hi = ctx.zero()
            for j in range(1, WORD_LIMBS):
                hi = hi + lv[val[1][j]]
            yield_constr.constraint(f * hi)
            yield_constr.constraint_transition(
                f * (nv[self.PC] - lv[val[1][0]]))
            yield_constr.constraint_transition(f * (nv[self.IS_KERNEL] - one))
            yield_constr.constraint_transition(f * nv[self.GAS])

        # EXIT_KERNEL: restore (pc, kernel, gas) (jumps.rs:12)
        f = op["exit_kernel"]
        v = val[1]
        yield_constr.constraint_transition(f * (nv[self.PC] - lv[v[0]]))
        yield_constr.constraint(f * lv[v[1]] * (lv[v[1]] - one))
        yield_constr.constraint_transition(
            f * (nv[self.IS_KERNEL] - lv[v[1]]))
        yield_constr.constraint_transition(f * (nv[self.GAS] - lv[v[6]]))
        yield_constr.constraint(f * lv[v[7]])

        # ---- channel used flags ---------------------------------------
        def used_sum(group, extra=()):
            s = ctx.zero()
            for f, _ in group:
                s = s + f
            for t in extra:
                s = s + t
            return s

        pd = (op["push"], op["dup"])
        ch_used(1, used_sum(pops1), *pd, op["swap"], op["syscall"],
                op["exception"])
        ch_used(2, used_sum(pops2), op["swap"], op["set_context"])
        # ch3: plain third pops + mload read + swap write-back +
        # set_context SP restore; jumps and shifts constrain ch3.used
        # themselves (witness-dependent)
        jump_shift = op["jump"] + op["jumpi"] + op["shl"] + op["shr"]
        yield_constr.constraint(
            (cyc - jump_shift) * (lv[self.CH_USED[3]]
                                  - used_sum(pops3)
                                  - op["mload_general"] - op["swap"]
                                  - op["set_context"]))
        push4 = ctx.zero()
        for f, _ in pushers:
            push4 = push4 + f
        ch_used(4, push4, *pd, op["swap"], op["mstore_general"])

        # ---- entry into execution: kernel main, empty stack, zero gas
        # (control_flow.rs:92)
        entry = boot * ncyc

        def entry_constr(e):
            yield_constr.constraint_transition(entry * e)
        entry_constr(nv[self.PC] - ctx.constant(self.main_pc))
        entry_constr(nv[self.SP])
        entry_constr(nv[self.GAS])
        entry_constr(nv[self.IS_KERNEL] - one)
        entry_constr(nv[self.CONTEXT])
        yield_constr.constraint_first_row(
            cyc * (pc - ctx.constant(self.main_pc)))
        yield_constr.constraint_first_row(cyc * sp)
        yield_constr.constraint_first_row(cyc * gas)
        yield_constr.constraint_first_row(cyc * (kernel - one))
        yield_constr.constraint_first_row(cyc * ectx)

        # ---- transitions: pc, sp, gas, kernel -------------------------
        incr = ctx.zero()   # natives with pc += 1, same kernel/mode
        for nop in NATIVE_OPS:
            if nop.name in ("jump", "jumpi", "exit_kernel", "halt"):
                continue
            incr = incr + op[nop.name]
        yield_constr.constraint_transition(incr * (nv[self.PC] - pc - one))
        yield_constr.constraint_transition(
            incr * (nv[self.IS_KERNEL] - kernel))

        # sp transition per op (stack.rs); set_context restores SP from
        # the new context's metadata (constrained above)
        for nop in NATIVE_OPS:
            if nop.name in ("halt", "set_context"):
                continue
            yield_constr.constraint_transition(
                op[nop.name] * (nv[self.SP] - sp
                                - ctx.constant(nop.sp_delta % P)))
        for name in ("syscall", "exception"):
            yield_constr.constraint_transition(
                op[name] * (nv[self.SP] - sp - one))

        # CONTEXT is preserved by every op except SET_CONTEXT (including
        # syscall/exception traps: the kernel handler runs in the
        # faulting context, contextops.rs)
        yield_constr.constraint_transition(
            (cyc - op["set_context"] - halt)
            * (nv[self.CONTEXT] - ectx))

        # gas accumulation with constant costs (gas.rs:20); syscall and
        # exception reset to 0 and exit_kernel restores — handled above
        for nop in NATIVE_OPS:
            if nop.gas is None:
                continue
            yield_constr.constraint_transition(
                op[nop.name] * (nv[self.GAS] - gas - ctx.constant(nop.gas)))

        # user stack bound: sp != 1025 outside the kernel
        # (stack_bounds.rs:22)
        yield_constr.constraint(
            cyc * ((sp - ctx.constant(MAX_USER_STACK_SIZE + 1))
                   * lv[self.SP_BOUNDS_AUX] - (one - kernel)))

    # ------------------------------------------------------------------
    # helpers

    def _channel(self, ctx, yield_constr, lv, ch: int, filt, is_read,
                 segment, virt, seg_expr=None, skip_used: bool = False,
                 context=None) -> None:
        """Bind channel ch's metadata when filt is set; unless
        skip_used, also force the channel on (dup_swap.rs:40
        constrain_channel_packed).  `context` is the memory context
        expression (None = context 0: kernel/shared segments)."""
        one = ctx.one()
        yield_constr.constraint(
            filt * (lv[self.CH_IS_READ[ch]] - is_read))
        ctx_expr = context if context is not None else ctx.zero()
        yield_constr.constraint(filt * (lv[self.CH_CTX[ch]] - ctx_expr))
        seg = lv[seg_expr] if seg_expr is not None \
            else ctx.constant(segment)
        yield_constr.constraint(filt * (lv[self.CH_SEGMENT[ch]] - seg))
        yield_constr.constraint(filt * (lv[self.CH_VIRT[ch]] - virt))
        if not skip_used:
            yield_constr.constraint(filt * (lv[self.CH_USED[ch]] - one))

    def _equal_values(self, yield_constr, lv, filt, ch_a: int, ch_b: int
                      ) -> None:
        """(dup_swap.rs:15 channels_equal_packed)"""
        for j in range(WORD_LIMBS):
            yield_constr.constraint(
                filt * (lv[self.CH_VALUE[ch_a][j]]
                        - lv[self.CH_VALUE[ch_b][j]]))

    def _pushed_scalar(self, ctx, yield_constr, lv, filt, value) -> None:
        """channel 4 pushes a single-limb scalar (pc.rs, push0.rs)."""
        yield_constr.constraint(filt * (lv[self.CH_VALUE[4][0]] - value))
        for j in range(1, WORD_LIMBS):
            yield_constr.constraint(filt * lv[self.CH_VALUE[4][j]])

    def constraint_degree(self) -> int:
        return 3
