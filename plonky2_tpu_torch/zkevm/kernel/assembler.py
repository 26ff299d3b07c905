"""Kernel assembler (twin of reference evm/src/cpu/kernel/assembler.rs
and ast.rs, re-targeted at the word-granular TPU machine).

The language is the reference's kernel asm dialect reduced to what the
word machine needs: `//` comments, `global label:` / `label:`
definitions, `%macro name(args) ... %endmacro` with `$arg`
substitution, `%name(...)` invocation, `PUSH <literal|label|@const>`,
and `WORDS w0 w1 ...` raw data words.  Because instructions are
word-granular (one (opcode, immediate) pair per pc), label values are
instruction indices, not byte offsets — there is no BYTES_PER_OFFSET
byte-packing (assembler.rs:20) and a jump target fits one PUSH.

Assembly is two passes (assembler.rs:60 assemble): expand macros and
assign label indices, then emit (opcode, imm) pairs.  All labels share
one namespace; `global` is kept for source compatibility and for
marking entry points in `global_labels`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..opcodes import NATIVE_OPS

WORD_MASK = (1 << 256) - 1

# mnemonic -> opcode: native blocks by name, syscall'd EVM ops by their
# standard mnemonic (they assemble to their EVM opcode and trap at run
# time), DUPn/SWAPn families, HALT as the kernel-mode STOP.
MNEMONICS: dict = {op.name.upper(): op.opcode for op in NATIVE_OPS}
MNEMONICS.update({
    "HALT": 0x00, "STOP": 0x00, "KECCAK256": 0x20, "EXP": 0x0A,
    "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53, "GAS": 0x5A,
    # signed-arithmetic syscalls (kernel/asm/signed.asm)
    "SDIV": 0x05, "SMOD": 0x07, "SIGNEXTEND": 0x0B,
    "SLT": 0x12, "SGT": 0x13, "SAR": 0x1D,
    # contract-frame syscalls (kernel/asm/contract.asm) + INVALID
    "ADDRESS": 0x30, "CALLER": 0x33, "CALLVALUE": 0x34,
    "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36,
    "SLOAD": 0x54, "SSTORE": 0x55,
    "RETURN": 0xF3, "REVERT": 0xFD, "INVALID": 0xFE,
    # inner message calls (round 5, contract.asm sys_call)
    "CALL": 0xF1, "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E,
    # user-mode 0xF4/0xFA (the kernel-only GET_CONTEXT native shares
    # 0xF4's byte; sys_delegatecall/sys_staticcall, contract.asm)
    "DELEGATECALL": 0xF4, "STATICCALL": 0xFA, "CALLCODE": 0xF2,
    # event logs (logs.asm sys_log)
    "LOG0": 0xA0, "LOG1": 0xA1, "LOG2": 0xA2, "LOG3": 0xA3, "LOG4": 0xA4,
    # contract creation (create.asm); user-mode 0xf5 is CREATE2 (the
    # kernel-only SET_CONTEXT native shares the byte)
    "CREATE": 0xF0, "CREATE2": 0xF5,
    "MSIZE": 0x59, "SELFDESTRUCT": 0xFF,
})
for _i in range(16):
    MNEMONICS[f"DUP{_i + 1}"] = 0x80 + _i
    MNEMONICS[f"SWAP{_i + 1}"] = 0x90 + _i

PUSH_OP = 0x60


@dataclass
class Macro:
    params: list
    body: list = field(default_factory=list)


def _tokenize(text: str) -> list:
    """Source lines stripped of comments and blanks."""
    out = []
    for raw in text.splitlines():
        line = raw.split("//")[0].strip()
        if line:
            out.append(line)
    return out


def _parse_macros(lines: list) -> tuple:
    """Split macro definitions from the instruction stream."""
    macros, body, cur = {}, [], None
    for line in lines:
        if line.startswith("%macro"):
            m = re.match(r"%macro\s+(\w+)(?:\((.*?)\))?$", line)
            assert m, f"bad macro header: {line}"
            params = [p.strip() for p in (m.group(2) or "").split(",")
                      if p.strip()]
            cur = macros[m.group(1)] = Macro(params)
        elif line == "%endmacro":
            cur = None
        elif cur is not None:
            cur.body.append(line)
        else:
            body.append(line)
    return macros, body


_UNIQUE = [0]


def _expand(lines: list, macros: dict, depth: int = 0) -> list:
    """Macro expansion with $arg substitution and `%%label` uniquing —
    each invocation gets fresh local labels (assembler.rs:150)."""
    assert depth < 16, "macro recursion"
    out = []
    for line in lines:
        if line.startswith("%stack"):
            out.extend(_stack_directive(line))
            continue
        m = re.match(r"%(\w+)(?:\((.*?)\))?$", line)
        if m and m.group(1) in macros:
            mac = macros[m.group(1)]
            args = [a.strip() for a in (m.group(2) or "").split(",")
                    if a.strip()]
            assert len(args) == len(mac.params), \
                f"macro %{m.group(1)} wants {mac.params}, got {args}"
            sub = dict(zip(mac.params, args))
            _UNIQUE[0] += 1
            uid = _UNIQUE[0]
            expanded = []
            for b in mac.body:
                for k, v in sub.items():
                    b = re.sub(r"\$" + k + r"\b", v, b)
                b = re.sub(r"%%(\w+)", rf"_u{uid}_\1", b)
                expanded.append(b)
            out.extend(_expand(expanded, macros, depth + 1))
        else:
            assert not line.startswith("%"), f"unknown macro: {line}"
            out.append(line)
    return out


def _stack_directive(line: str) -> list:
    """`%stack (in1, in2, ...) -> (out1, out2, ...)` — a named stack
    transform compiled to DUP/SWAP/PUSH/POP (the reference assembler's
    %stack macro, assembler.rs / stack manipulation).  Inputs are names
    for the top |in| stack slots (top first); outputs are names or
    PUSH-able tokens (literals, labels, @constants).  Shape: build the
    outputs above the inputs with DUP/PUSH, then drop the inputs with a
    SWAP(k)+POP rotation, pre-rotating the build order so the |in|
    left-rotations land the outputs in the requested order."""
    m = re.match(r"%stack\s*\((.*?)\)\s*->\s*\((.*?)\)$", line)
    assert m, f"bad %stack: {line}"
    ins = [t.strip() for t in m.group(1).split(",") if t.strip()]
    outs = [t.strip() for t in m.group(2).split(",") if t.strip()]
    assert len(ins) == len(set(ins)), f"duplicate %stack inputs: {line}"
    n, k = len(ins), len(outs)
    assert n <= 16 and k <= 16, f"%stack too deep: {line}"
    if k == 0:
        return ["POP"] * n
    # desired outs rotated right by n mod k compensates the n rotations
    r = n % k
    build = outs[-r:] + outs[:-r] if r else list(outs)
    code = []
    for j, tok in enumerate(reversed(build)):   # deepest output first
        if tok in ins:
            depth = ins.index(tok) + j + 1
            assert depth <= 16, f"%stack DUP depth {depth}: {line}"
            code.append(f"DUP{depth}")
        else:
            code.append(f"PUSH {tok}")
    for _ in range(n):
        assert k <= 16, f"%stack SWAP depth {k}: {line}"
        code.append(f"SWAP{k}" if k else "POP")
        code.append("POP")
    return code


def _resolve(tok: str, labels: dict, constants: dict) -> int:
    if tok.startswith("@"):
        return constants[tok[1:]] & WORD_MASK
    if tok in labels:
        return labels[tok]
    if re.fullmatch(r"-?(0x[0-9a-fA-F]+|\d+)", tok):
        return int(tok, 0) & WORD_MASK
    raise KeyError(f"unresolved symbol: {tok}")


_LIT = re.compile(r"-?(0x[0-9a-fA-F]+|\d+)$")

# PUSH a; PUSH b; OP — top of stack is b (pushed last)
_FOLD2 = {
    "ADD": lambda a, b: a + b,
    "MUL": lambda a, b: a * b,
    "SUB": lambda a, b: b - a,          # top - second
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "XOR": lambda a, b: a ^ b,
    "SHL": lambda a, b: a << min(b, 256),   # shift (top) = b
    "SHR": lambda a, b: a >> min(b, 256),
    "EQ": lambda a, b: int(a == b),
    "LT": lambda a, b: int(b < a),      # top < second
    "GT": lambda a, b: int(b > a),
    "ISZERO": None,                      # unary, handled separately
}


def optimize(lines: list) -> list:
    """Peephole constant folding + dead-stack elimination on the
    expanded instruction stream, BEFORE label assignment — so removing
    instructions cannot skew jump targets (twin of the reference
    cpu/kernel/optimizer.rs, which also rewrites pre-layout AST).
    Label definitions act as barriers: no window crosses one.

    Rules (iterated to fixpoint):
      PUSH a; PUSH b; binop     -> PUSH (a binop b)   (numeric a, b)
      PUSH a; ISZERO            -> PUSH (a == 0)
      PUSH a; NOT               -> PUSH (~a mod 2^256)
      PUSH x; POP               -> (nothing)
      DUPn; POP                 -> (nothing)
      SWAPn; SWAPn              -> (nothing)
      PUSH 0; ADD / PUSH 0; XOR / PUSH 0; OR / PUSH 0; SHL / PUSH 0; SHR
                                -> (nothing)            (identities)
      ISZERO; ISZERO; PUSH l; JUMPI -> PUSH l; JUMPI   (truthiness)
    """
    def lit(line):
        p = line.split()
        if len(p) == 2 and p[0].upper() == "PUSH" and _LIT.match(p[1]):
            return int(p[1], 0) & WORD_MASK
        return None

    def is_label(line):
        return re.match(r"(global\s+)?(\w+):$", line) is not None

    changed = True
    while changed:
        changed = False
        out = []
        i = 0
        n = len(lines)
        while i < n:
            l0 = lines[i]
            u0 = l0.split()[0].upper() if not is_label(l0) else None
            a = lit(l0)
            l1 = lines[i + 1] if i + 1 < n else None
            u1 = (l1.split()[0].upper()
                  if l1 is not None and not is_label(l1) else None)
            l2 = lines[i + 2] if i + 2 < n else None
            u2 = (l2.split()[0].upper()
                  if l2 is not None and not is_label(l2) else None)
            # PUSH a; PUSH b; binop
            if a is not None and l1 is not None and lit(l1) is not None \
                    and u2 in _FOLD2 and u2 != "ISZERO":
                v = _FOLD2[u2](a, lit(l1)) & WORD_MASK
                out.append(f"PUSH {v}")
                i += 3
                changed = True
                continue
            # PUSH a; unary
            if a is not None and u1 == "ISZERO":
                out.append(f"PUSH {int(a == 0)}")
                i += 2
                changed = True
                continue
            if a is not None and u1 == "NOT":
                out.append(f"PUSH {(~a) & WORD_MASK}")
                i += 2
                changed = True
                continue
            # PUSH/DUP followed by POP
            if u1 == "POP" and (a is not None or
                                (u0 is not None and u0.startswith("DUP"))):
                i += 2
                changed = True
                continue
            # SWAPn; SWAPn
            if u0 is not None and u0.startswith("SWAP") and u1 == u0:
                i += 2
                changed = True
                continue
            # identity constants
            if a == 0 and u1 in ("ADD", "XOR", "OR", "SHL", "SHR"):
                i += 2
                changed = True
                continue
            # double negation before a conditional jump
            if u0 == "ISZERO" and u1 == "ISZERO" and l2 is not None \
                    and lit(l2) is None and u2 == "PUSH" \
                    and i + 3 < n and not is_label(lines[i + 3]) \
                    and lines[i + 3].split()[0].upper() == "JUMPI":
                i += 2
                changed = True
                continue
            out.append(l0)
            i += 1
        lines = out
    return lines


def assemble(sources: list, constants: dict | None = None,
             base: int = 0, optimize_code: bool = True) -> tuple:
    """Assemble source strings into (code, global_labels) where code is
    a list of (opcode, immediate) pairs — one per pc — and
    global_labels maps `global`-declared names to instruction indices
    (assembler.rs:60).  `base` offsets all label values — user programs
    assemble against their load address Kernel.user_base.
    optimize_code runs the peephole pass (optimizer.rs twin): fewer
    instructions = fewer CPU rows = directly cheaper proofs."""
    constants = constants or {}
    macros, lines = {}, []
    for src in sources:
        ms, body = _parse_macros(_tokenize(src))
        overlap = set(ms) & set(macros)
        assert not overlap, f"duplicate macros: {overlap}"
        macros.update(ms)
        lines.extend(body)
    lines = _expand(lines, macros)
    if optimize_code:
        lines = optimize(lines)

    # pass 1: label indices
    labels, global_labels, pc = {}, {}, base
    for line in lines:
        m = re.match(r"(global\s+)?(\w+):$", line)
        if m:
            name = m.group(2)
            assert name not in labels, f"duplicate label {name}"
            labels[name] = pc
            if m.group(1):
                global_labels[name] = pc
        elif line.split()[0].upper() == "WORDS":
            pc += len(line.split()) - 1
        else:
            pc += 1

    # pass 2: emit
    code = []
    for line in lines:
        if re.match(r"(global\s+)?(\w+):$", line):
            continue
        parts = line.split()
        mnem = parts[0].upper()
        if mnem == "WORDS":
            for tok in parts[1:]:
                code.append((PUSH_OP, _resolve(tok, labels, constants)))
            continue
        if mnem == "PUSH":
            assert len(parts) == 2, f"PUSH needs one operand: {line}"
            code.append((PUSH_OP, _resolve(parts[1], labels, constants)))
            continue
        assert len(parts) == 1, f"unexpected operand: {line}"
        assert mnem in MNEMONICS, f"unknown mnemonic: {mnem}"
        code.append((MNEMONICS[mnem], 0))
    return code, global_labels
