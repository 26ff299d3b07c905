"""Kernel aggregation: assemble the asm routines, build the jumptables
and the bootstrap memory image (twin of reference
evm/src/cpu/kernel/aggregator.rs:10 combined_kernel and
constants/global_metadata.rs).

The `Kernel` is public: the verifier rebuilds the bootstrap image from
it (plus the public user code and block metadata) and recomputes the
program-ROM commitment, binding the executed machine state to public
data (program.py; replaces the reference's in-kernel code hashing).

Image layout (segments in cpu.py):
- SEG_CODE: kernel code words, then user code words at USER_BASE
  (2 words per instruction: opcode, immediate);
- SEG_JUMPTABLE: syscall handlers at [opcode], exception handlers at
  [256 + exc_code]; unrouted entries hold `panic` so a mis-decoded
  native op or fake trap can never be proven (syscalls.rs:28);
- SEG_SHIFT: 2^i mod 2^256 at [i] for SHL/SHR (Segment::ShiftTable);
- SEG_JUMPDEST: 1 at [pc] for each user JUMPDEST instruction — the
  TPU-native replacement for the kernel's jumpdest analysis
  (asm/core/jumpdest_analysis.asm): the bits are public inputs via the
  ROM commitment rather than kernel-computed;
- SEG_GLOBAL: block metadata + trie-root digests (proof.rs:51
  PublicValues), opcode bitmask words, and the per-opcode minimum
  stack-length table at GLOBAL_MIN_SP_BASE (exception.asm:141).
"""

from __future__ import annotations

from importlib import resources

from ...field import secp256k1 as _secp
from ..opcodes import (NATIVE_OPS, SYSCALL_MIN_STACK, decode_native,
                       min_stack_len)
from .assembler import assemble

WORD_MASK = (1 << 256) - 1

# global-metadata slots (constants/global_metadata.rs, reduced)
GLOBAL_BLOCK_BENEFICIARY = 0
GLOBAL_BLOCK_TIMESTAMP = 1
GLOBAL_BLOCK_NUMBER = 2
GLOBAL_BLOCK_DIFFICULTY = 3
GLOBAL_BLOCK_GASLIMIT = 4
GLOBAL_BLOCK_CHAIN_ID = 5
GLOBAL_BLOCK_BASE_FEE = 6
GLOBAL_STATE_ROOT_BEFORE = 7
GLOBAL_STATE_ROOT_AFTER = 8
GLOBAL_TXN_ROOT_BEFORE = 9
GLOBAL_TXN_ROOT_AFTER = 10
GLOBAL_RECEIPT_ROOT_BEFORE = 11
GLOBAL_RECEIPT_ROOT_AFTER = 12
GLOBAL_INVALID_OPCODES_USER = 13
GLOBAL_STACK_INCREASING_USER = 14
GLOBAL_EXC_STATUS = 15
# runtime kernel state (never in the image; fresh reads give 0)
GLOBAL_TRIE_ALLOC = 16       # SEG_TRIE bump allocator (0 = null ptr)
GLOBAL_RLP_ALLOC = 17        # SEG_RLP bump allocator
GLOBAL_STATE_TRIE_PTR = 18
GLOBAL_TXN_TRIE_PTR = 19
GLOBAL_RECEIPT_TRIE_PTR = 20
# transfer-txn public claims (signature checking is out of scope this
# round — the txn fields are public inputs bound via the ROM image)
GLOBAL_TXN_SENDER = 21
GLOBAL_TXN_TO = 22
GLOBAL_TXN_VALUE = 23
GLOBAL_TXN_NONCE = 24
GLOBAL_TXN_GASPRICE = 25
GLOBAL_TXN_COUNT = 26        # 0 = empty block (roots must be unchanged)
# contract execution (round 4; contract.asm)
GLOBAL_NEXT_CTX = 27         # context-id allocator (ids start at 1)
GLOBAL_TXN_FAILED = 28       # 1 after a contract REVERT/fault (receipt status)
GLOBAL_GAS_USED = 29         # executed frames' gas (receipt gas = 21000 + this)
GLOBAL_JOURNAL_LEN = 30      # journal entry count (4 cells each, SEG_JOURNAL)
GLOBAL_JOURNAL_CKPT = 31     # checkpoint for revert_journal
GLOBAL_EXEC_RET = 32         # kernel continuation pc after a contract frame
GLOBAL_RETURNDATA_LEN = 33   # byte length of (0, SEG_RETURNDATA)
GLOBAL_DRY_RUN = 34          # 1: check_root publishes instead of checking
GLOBAL_TXN_DATA_LEN = 35     # calldata byte length (public txn data)
# round-5 signed transactions (kernel/asm/curve.asm verify_txn_signature):
# SIG_R = 0 means an unsigned txn (the earlier reduction) — signature
# checking is skipped; otherwise the sender is recovered in-kernel from
# keccak(unsigned txn RLP) and must equal @GLOBAL_TXN_SENDER.
GLOBAL_TXN_SIG_V = 36        # 27 or 28
GLOBAL_TXN_SIG_R = 37
GLOBAL_TXN_SIG_S = 38
GLOBAL_EC_BASE = 39          # curve.asm scratch-cell base pointer
GLOBAL_CALL_DEPTH = 40       # message-call depth (EVM 1024 cap, sys_call)
GLOBAL_FRAME_STATUS = 41     # last frame's exit status (contract_exit)
GLOBAL_LOG_COUNT = 42        # surviving event logs (logs.asm sys_log)
GLOBAL_LOG_ALLOC = 43        # (0, SEG_LOGS) bump allocator
GLOBAL_LAST_FRAME_GAS = 44   # gas a finished frame charges its parent
GLOBAL_INTRINSIC_GAS = 45    # 21000 + calldata gas (txn.asm, EIP-2028)
GLOBAL_REFUND = 46           # SSTORE-clearing refund counter (EIP-3529)
GLOBAL_CALL_GASCAP = 47      # 63/64-capped gas for the child being called
GLOBAL_SHA_BASE = 48         # sha256.asm per-call state base pointer
GLOBAL_CALL_KIND = 49        # 0=CALL 1=DELEGATECALL 2=STATICCALL (sys_call)
GLOBAL_RIPEMD_BASE = 50      # ripemd160.asm per-call state base pointer
GLOBAL_ALIST_LEN = 51        # EIP-2929 accessed-addresses count (access.asm)
GLOBAL_SLIST_LEN = 52        # EIP-2929 accessed-storage-keys count
GLOBAL_TXN_DATA_BASE = 64    # calldata words, 32 bytes each, big-endian
GLOBAL_MIN_SP_BASE = 256

# Default block gas limit when the caller leaves the slot unset.  The
# image and the Simulator MUST share this default: sys_stop checks
# gas_used <= @GLOBAL_GASLIMIT, so an image slot of 0 would make every
# gas-charging program that halts via STOP spin in panic forever.
DEFAULT_BLOCK_GASLIMIT = (1 << 32) - 1

SYSCALL_ROUTES = {
    0x00: "sys_stop", 0x0A: "sys_exp", 0x20: "sys_keccak256",
    0x51: "sys_mload", 0x52: "sys_mstore", 0x53: "sys_mstore8",
    0x5A: "sys_gas",
    # signed arithmetic (kernel/asm/signed.asm, reference asm/signed.asm)
    0x05: "sys_sdiv", 0x07: "sys_smod", 0x0B: "sys_signextend",
    0x12: "sys_slt", 0x13: "sys_sgt", 0x1D: "sys_sar",
    # contract-frame environment + storage + exits (contract.asm)
    0x30: "sys_address", 0x33: "sys_caller", 0x34: "sys_callvalue",
    0x35: "sys_calldataload", 0x36: "sys_calldatasize",
    0x54: "sys_sload", 0x55: "sys_sstore",
    0xF3: "sys_return", 0xFD: "sys_revert",
    # inner message calls (round 5)
    0xF1: "sys_call", 0x3D: "sys_returndatasize",
    0x3E: "sys_returndatacopy",
    # DELEGATECALL/STATICCALL (user 0xF4/0xFA — the NATIVE 0xF4/0xF5
    # context ops are kernel-only, so these opcodes syscall in user mode)
    0xF4: "sys_delegatecall", 0xFA: "sys_staticcall",
    0xF2: "sys_callcode",
    # event logs (logs.asm)
    0xA0: "sys_log", 0xA1: "sys_log", 0xA2: "sys_log",
    0xA3: "sys_log", 0xA4: "sys_log",
    # contract creation (create.asm)
    0xF0: "sys_create", 0xF5: "sys_create2",
    # memory size (gas.asm)
    0x59: "sys_msize",
    # self-destruct (contract.asm, EIP-6780 reduced)
    0xFF: "sys_selfdestruct",
}
# user opcodes that grow the stack via their syscall handler (GAS,
# environment pushes); the simulator traps EXC_STACK_OVERFLOW for
# these before syscall dispatch
SYSCALL_STACK_INCREASING = {0x5A, 0x30, 0x33, 0x34, 0x36, 0x3D, 0x59}
EXC_ROUTES = ("exc_out_of_gas", "exc_invalid_opcode",
              "exc_stack_underflow", "exc_invalid_jump",
              "exc_invalid_jumpi", "exc_stack_overflow", "panic", "panic")

# package data (pyproject.toml), found from a checkout or an installed wheel
ASM_DIR = resources.files(__package__).joinpath("asm")
CORE_FILES = ("core.asm", "exceptions.asm", "syscalls.asm", "signed.asm",
              "memory.asm", "rlp.asm", "mpt.asm", "mpt_ops.asm",
              "curve.asm", "bn_curve.asm", "sha256.asm", "blake2f.asm",
              "ripemd160.asm", "contract.asm", "access.asm",
              "precompiles.asm", "logs.asm", "create.asm", "gas.asm",
              "txn.asm")


def user_opcode_is_valid(opcode: int) -> bool:
    """Valid in user mode: a user-available native block or an
    implemented syscall (the round-2 INVALID_OPCODES_USER complement,
    constants/exc_bitfields.rs)."""
    op = decode_native(opcode, kernel_mode=False)
    if op is not None:
        return True
    return opcode in SYSCALL_ROUTES


def invalid_opcodes_user_mask() -> int:
    return sum(1 << oc for oc in range(256)
               if not user_opcode_is_valid(oc))


def stack_increasing_user_mask() -> int:
    """Opcodes that grow the user stack by one
    (exc_bitfields.rs STACK_LENGTH_INCREASING_OPCODES_USER).  Includes
    stack-growing SYSCALLS (GAS): the simulator traps the overflow
    BEFORE the syscall dispatch (generation.py SYSCALL_STACK_INCREASING),
    and exc_stack_overflow consults this mask to accept the trap —
    without the bit a legitimate overflow on GAS lands in panic and the
    program becomes unprovable (the syscall path is no escape: sys_gas's
    push would leave user sp = 1025, which the AIR rejects)."""
    mask = 0
    for oc in range(256):
        op = decode_native(oc, kernel_mode=False)
        if (op is not None and op.sp_delta == 1) or \
                (op is None and oc in SYSCALL_STACK_INCREASING):
            mask |= 1 << oc
    return mask


class Kernel:
    def __init__(self, code: list, global_labels: dict):
        self.code = code
        self.global_labels = global_labels
        self.main_pc = global_labels["main"]
        self.user_base = len(code)

    def image(self, user_code: list | None = None,
              global_values: dict | None = None) -> list:
        """The bootstrap memory image: (segment, virt, value) triples
        with distinct addresses (generation/mod.rs:79
        apply_metadata_memops + bootstrap_kernel.rs)."""
        from ..cpu import (SEG_CODE, SEG_GLOBAL, SEG_JUMPDEST,
                           SEG_JUMPTABLE, SEG_SHIFT)
        user_code = user_code or []
        entries = []
        code = self.code + list(user_code)
        for i, (opcode, imm) in enumerate(code):
            entries.append((SEG_CODE, 2 * i, opcode))
            if imm:
                entries.append((SEG_CODE, 2 * i + 1, imm & WORD_MASK))
        labels = self.global_labels
        panic = labels["panic"]
        for oc in range(256):
            route = SYSCALL_ROUTES.get(oc)
            if decode_native(oc, kernel_mode=False) is not None:
                route = None    # native in user mode: trap => panic
            pc = labels[route] if route else panic
            if pc:
                entries.append((SEG_JUMPTABLE, oc, pc))
        for code_, name in enumerate(EXC_ROUTES):
            pc = labels[name]
            if pc:
                entries.append((SEG_JUMPTABLE, 256 + code_, pc))
        for i in range(256):
            entries.append((SEG_SHIFT, i, (1 << i) & WORD_MASK))
        for i, (opcode, _) in enumerate(user_code):
            if opcode == 0x5B:  # JUMPDEST
                entries.append((SEG_JUMPDEST, self.user_base + i, 1))
        gv = {GLOBAL_INVALID_OPCODES_USER: invalid_opcodes_user_mask(),
              GLOBAL_STACK_INCREASING_USER: stack_increasing_user_mask(),
              GLOBAL_BLOCK_GASLIMIT: DEFAULT_BLOCK_GASLIMIT}
        for oc in range(256):
            ms = min_stack_len(oc)
            if ms:
                gv[GLOBAL_MIN_SP_BASE + oc] = ms
        gv.update(global_values or {})
        for idx, value in sorted(gv.items()):
            if value:
                entries.append((SEG_GLOBAL, idx, value & WORD_MASK))
        assert len({(s, v) for s, v, _ in entries}) == len(entries), \
            "image addresses must be distinct"
        return entries


def build_kernel(extra_sources: list = (), constants: dict | None = None,
                 main_source: str | None = None) -> Kernel:
    """Assemble the kernel from the core asm files plus any extras;
    `main_source` overrides main.asm for kernel-only test programs
    (aggregator.rs:10 combined_kernel)."""
    from .. import cpu
    consts = {
        "SEGMENT_CODE": cpu.SEG_CODE, "SEGMENT_STACK": cpu.SEG_STACK,
        "SEGMENT_MAIN": cpu.SEG_MAIN, "SEGMENT_BYTES": cpu.SEG_BYTES,
        "SEGMENT_JUMPTABLE": cpu.SEG_JUMPTABLE,
        "SEGMENT_SHIFT": cpu.SEG_SHIFT,
        "SEGMENT_JUMPDEST": cpu.SEG_JUMPDEST,
        "SEGMENT_GLOBAL": cpu.SEG_GLOBAL,
        "SEGMENT_TRIE": cpu.SEG_TRIE,
        "SEGMENT_RLP": cpu.SEG_RLP,
        "SEGMENT_CALLDATA": cpu.SEG_CALLDATA,
        "SEGMENT_RETURNDATA": cpu.SEG_RETURNDATA,
        "SEGMENT_CTX_META": cpu.SEG_CTX_META,
        "SEGMENT_JOURNAL": cpu.SEG_JOURNAL,
        "SEGMENT_LOGS": cpu.SEG_LOGS,
        "CTX_ACCT_VPTR": cpu.META_ACCT_VPTR,
        "CTX_ADDRESS": cpu.META_ADDRESS,
        "CTX_CALLER": cpu.META_CALLER,
        "CTX_CALLVALUE": cpu.META_CALLVALUE,
        "CTX_CALLDATA_SIZE": cpu.META_CALLDATA_SIZE,
        "CTX_PARENT_CTX": cpu.META_PARENT_CTX,
        "CTX_PARENT_PC": cpu.META_PARENT_PC,
        "CTX_CKPT": cpu.META_CKPT,
        "CTX_STATIC": cpu.META_STATIC,
        "CTX_MSIZE": cpu.META_MSIZE,
        "CTX_GASLIMIT": cpu.META_GASLIMIT,
        "J_BALANCE": 1, "J_STORAGE": 2, "J_SABSENT": 3, "J_CREATE": 4,
        "J_LOG": 5, "J_NONCE": 6, "J_CODEHASH": 7, "J_REFUND": 8,
        "J_ALIST": 9, "J_SLIST": 10,
        "SEGMENT_ACCESS": cpu.SEG_ACCESS,
        "ACCESS_SLOT_BASE": 1 << 20,
        "GLOBAL_ALIST_LEN": GLOBAL_ALIST_LEN,
        "GLOBAL_SLIST_LEN": GLOBAL_SLIST_LEN,
        "GLOBAL_LOG_COUNT": GLOBAL_LOG_COUNT,
        "GLOBAL_LOG_ALLOC": GLOBAL_LOG_ALLOC,
        "GLOBAL_LAST_FRAME_GAS": GLOBAL_LAST_FRAME_GAS,
        "GLOBAL_INTRINSIC_GAS": GLOBAL_INTRINSIC_GAS,
        "GLOBAL_REFUND": GLOBAL_REFUND,
        "GLOBAL_CALL_GASCAP": GLOBAL_CALL_GASCAP,
        "GLOBAL_SHA_BASE": GLOBAL_SHA_BASE,
        "GLOBAL_CALL_KIND": GLOBAL_CALL_KIND,
        "GLOBAL_RIPEMD_BASE": GLOBAL_RIPEMD_BASE,
        "GLOBAL_NEXT_CTX": GLOBAL_NEXT_CTX,
        "GLOBAL_TXN_FAILED": GLOBAL_TXN_FAILED,
        "GLOBAL_GAS_USED": GLOBAL_GAS_USED,
        "GLOBAL_JOURNAL_LEN": GLOBAL_JOURNAL_LEN,
        "GLOBAL_JOURNAL_CKPT": GLOBAL_JOURNAL_CKPT,
        "GLOBAL_EXEC_RET": GLOBAL_EXEC_RET,
        "GLOBAL_RETURNDATA_LEN": GLOBAL_RETURNDATA_LEN,
        "GLOBAL_DRY_RUN": GLOBAL_DRY_RUN,
        "GLOBAL_TXN_DATA_LEN": GLOBAL_TXN_DATA_LEN,
        "GLOBAL_TXN_DATA_BASE": GLOBAL_TXN_DATA_BASE,
        "GLOBAL_TXN_SIG_V": GLOBAL_TXN_SIG_V,
        "GLOBAL_TXN_SIG_R": GLOBAL_TXN_SIG_R,
        "GLOBAL_TXN_SIG_S": GLOBAL_TXN_SIG_S,
        "GLOBAL_EC_BASE": GLOBAL_EC_BASE,
        "GLOBAL_CALL_DEPTH": GLOBAL_CALL_DEPTH,
        "GLOBAL_FRAME_STATUS": GLOBAL_FRAME_STATUS,
        # secp256k1 (field/secp256k1.py; curve.asm ecrecover)
        "SECP_P": _secp.SECP256K1_BASE.order,
        "SECP_N": _secp.SECP256K1_SCALAR.order,
        "SECP_GX": _secp.GX,
        "SECP_GY": _secp.GY,
        "GLOBAL_GASLIMIT": GLOBAL_BLOCK_GASLIMIT,
        "GLOBAL_INVALID_OPCODES_USER": GLOBAL_INVALID_OPCODES_USER,
        "GLOBAL_STACK_INCREASING_USER": GLOBAL_STACK_INCREASING_USER,
        "GLOBAL_EXC_STATUS": GLOBAL_EXC_STATUS,
        "GLOBAL_MIN_SP_BASE": GLOBAL_MIN_SP_BASE,
        "GLOBAL_STATE_ROOT_BEFORE": GLOBAL_STATE_ROOT_BEFORE,
        "GLOBAL_STATE_ROOT_AFTER": GLOBAL_STATE_ROOT_AFTER,
        "GLOBAL_TXN_ROOT_BEFORE": GLOBAL_TXN_ROOT_BEFORE,
        "GLOBAL_TXN_ROOT_AFTER": GLOBAL_TXN_ROOT_AFTER,
        "GLOBAL_RECEIPT_ROOT_BEFORE": GLOBAL_RECEIPT_ROOT_BEFORE,
        "GLOBAL_RECEIPT_ROOT_AFTER": GLOBAL_RECEIPT_ROOT_AFTER,
        "GLOBAL_TRIE_ALLOC": GLOBAL_TRIE_ALLOC,
        "GLOBAL_RLP_ALLOC": GLOBAL_RLP_ALLOC,
        "GLOBAL_STATE_TRIE_PTR": GLOBAL_STATE_TRIE_PTR,
        "GLOBAL_TXN_TRIE_PTR": GLOBAL_TXN_TRIE_PTR,
        "GLOBAL_RECEIPT_TRIE_PTR": GLOBAL_RECEIPT_TRIE_PTR,
        "GLOBAL_TXN_SENDER": GLOBAL_TXN_SENDER,
        "GLOBAL_TXN_TO": GLOBAL_TXN_TO,
        "GLOBAL_TXN_VALUE": GLOBAL_TXN_VALUE,
        "GLOBAL_TXN_NONCE": GLOBAL_TXN_NONCE,
        "GLOBAL_TXN_GASPRICE": GLOBAL_TXN_GASPRICE,
        "GLOBAL_TXN_COUNT": GLOBAL_TXN_COUNT,
        "GLOBAL_BLOCK_BENEFICIARY": GLOBAL_BLOCK_BENEFICIARY,
        "GLOBAL_BLOCK_BASE_FEE": GLOBAL_BLOCK_BASE_FEE,
        "MPT_EMPTY": 0, "MPT_HASH": 1, "MPT_BRANCH": 2,
        "MPT_EXTENSION": 3, "MPT_LEAF": 4,
        # BN254 base-field modulus (arithmetic.py BN_BASE)
        "BN_P": 21888242871839275222246405745257275088696311157297823662689037894645226208583,
        # keccak("") as a big-endian word (mpt.py EMPTY_CODE_HASH)
        "EMPTY_CODE_HASH": int.from_bytes(bytes.fromhex(
            "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
        ), "big"),
    }
    consts.update(constants or {})
    sources = [ASM_DIR.joinpath(f).read_text() for f in CORE_FILES]
    sources.append(main_source if main_source is not None
                   else ASM_DIR.joinpath("main.asm").read_text())
    sources.extend(extra_sources)

    # two-phase: USER_BASE depends on the assembled length, which the
    # PUSH-per-instruction word encoding keeps independent of the
    # constant's value
    code, labels = assemble(sources, {**consts, "USER_BASE": 0})
    consts["USER_BASE"] = len(code)
    code, labels = assemble(sources, consts)
    assert len(code) == consts["USER_BASE"]
    return Kernel(code, labels)


KERNEL = build_kernel()
