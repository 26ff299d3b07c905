// Signed-arithmetic syscall handlers: SDIV, SMOD, SIGNEXTEND, SLT,
// SGT, SAR (twin of reference cpu/kernel/asm/signed.asm, re-targeted
// at the word machine's native unsigned ALU).  Two's-complement
// decomposition: sign = x >> 255, |x| = sign ? 0 - x : x; the unsigned
// DIV/MOD/LT lanes do the work and the result is re-signed.  The
// INT256_MIN edge cases come out right for free mod 2^256
// (|-2^255| = 2^255, and its negation is itself).
//
// Stack comments are bottom -> top, like syscalls.asm; on entry the
// user operands sit below the trap word.

// [.., x] -> [.., -x]   (0 - x mod 2^256)
%macro neg
    PUSH 0
    SUB
%endmacro

// [.., x] -> [.., |x|]
%macro abs
    DUP1
    PUSH 255
    SHR              // [x, sign]
    ISZERO
    %jumpi(%%pos)
    %neg
%%pos:
%endmacro

// [.., a, b] -> [.., a <s b]   (signed compare; b on top)
%macro signed_lt
    DUP2
    PUSH 255
    SHR              // [a, b, sa]
    DUP2
    PUSH 255
    SHR              // [a, b, sa, sb]
    DUP2
    DUP2
    EQ               // [a, b, sa, sb, same]
    %jumpi(%%same)
    // signs differ: a <s b iff a is the negative one
    POP              // [a, b, sa]
    SWAP2            // [sa, b, a]
    POP
    POP              // [sa]
    %jump(%%end)
%%same:
    POP
    POP              // [a, b]
    SWAP1            // [b, a]
    LT               // [a <u b] — same-sign two's complement preserves order
%%end:
%endmacro

global sys_slt:
    // entry: [b, a, trap] — a was the user stack top
    SWAP2            // [trap, a, b]
    %signed_lt       // [trap, a <s b]
    SWAP1
    %charge_gas(3)
    EXIT_KERNEL

global sys_sgt:
    SWAP2            // [trap, a, b]
    SWAP1            // [trap, b, a]
    %signed_lt       // [trap, b <s a] = a >s b
    SWAP1
    %charge_gas(3)
    EXIT_KERNEL

global sys_sdiv:
    // entry: [den, num, trap]; result trunc(num / den), 0 if den == 0
    SWAP2            // [trap, num, den]
    DUP1
    ISZERO
    %jumpi(sdiv_zero)
    DUP2
    PUSH 255
    SHR              // [trap, num, den, sn]
    DUP2
    PUSH 255
    SHR              // [trap, num, den, sn, sd]
    XOR              // [trap, num, den, rsign]
    SWAP2            // [trap, rsign, den, num]
    %abs             // [trap, rsign, den, |num|]
    SWAP1            // [trap, rsign, |num|, den]
    %abs             // [trap, rsign, |num|, |den|]
    SWAP1            // [trap, rsign, |den|, |num|]
    DIV              // [trap, rsign, q]
    SWAP1            // [trap, q, rsign]
    ISZERO
    %jumpi(sdiv_done)
    %neg
sdiv_done:
    SWAP1
    %charge_gas(5)
    EXIT_KERNEL
sdiv_zero:
    POP
    POP              // [trap]
    PUSH 0
    SWAP1
    %charge_gas(5)
    EXIT_KERNEL

global sys_smod:
    // entry: [den, num, trap]; result sign follows the dividend
    SWAP2            // [trap, num, den]
    DUP1
    ISZERO
    %jumpi(smod_zero)
    DUP2
    PUSH 255
    SHR              // [trap, num, den, sn]
    SWAP2            // [trap, sn, den, num]
    %abs             // [trap, sn, den, |num|]
    SWAP1            // [trap, sn, |num|, den]
    %abs             // [trap, sn, |num|, |den|]
    SWAP1            // [trap, sn, |den|, |num|]
    MOD              // [trap, sn, r]
    SWAP1            // [trap, r, sn]
    ISZERO
    %jumpi(smod_done)
    %neg
smod_done:
    SWAP1
    %charge_gas(5)
    EXIT_KERNEL
smod_zero:
    POP
    POP
    PUSH 0
    SWAP1
    %charge_gas(5)
    EXIT_KERNEL

global sys_signextend:
    // entry: [x, k, trap]; extend the sign bit of byte k (LE index)
    SWAP2            // [trap, k, x]
    DUP2             // [trap, k, x, k]
    PUSH 30
    LT               // [trap, k, x, 30 < k]
    %jumpi(sext_id)
    // t = 8*(k+1); xl = x & (2^t - 1); s = (x >> (t-1)) & 1
    SWAP1            // [trap, x, k]
    PUSH 1
    ADD              // [trap, x, k+1]
    PUSH 8
    MUL              // [trap, x, t]
    DUP1             // [trap, x, t, t]
    PUSH 1           // [trap, x, t, t, 1]
    SWAP1            // [trap, x, t, 1, t]
    SHL              // [trap, x, t, 2^t]
    PUSH 1           // [trap, x, t, 2^t, 1]
    SWAP1            // [trap, x, t, 1, 2^t]
    SUB              // [trap, x, t, mask]
    DUP3             // [trap, x, t, mask, x]
    AND              // [trap, x, t, xl]
    SWAP2            // [trap, xl, t, x]
    DUP2             // [trap, xl, t, x, t]
    PUSH 1           // [trap, xl, t, x, t, 1]
    SWAP1            // [trap, xl, t, x, 1, t]
    SUB              // [trap, xl, t, x, t-1]
    SHR              // [trap, xl, t, x >> (t-1)]
    PUSH 1
    AND              // [trap, xl, t, s]
    ISZERO
    %jumpi(sext_pos)
    // negative: result = xl | (ones << t)
    PUSH 0
    NOT              // [trap, xl, t, ones]
    SWAP1            // [trap, xl, ones, t]
    SHL              // [trap, xl, ones << t]
    OR               // [trap, result]
    %jump(sext_done)
sext_pos:
    POP              // [trap, xl]
sext_done:
    SWAP1
    %charge_gas(5)
    EXIT_KERNEL
sext_id:
    // [trap, k, x]
    SWAP1
    POP              // [trap, x]
    SWAP1
    %charge_gas(5)
    EXIT_KERNEL

global sys_sar:
    // entry: [x, d, trap]; arithmetic shift right
    SWAP2            // [trap, d, x]
    DUP1
    PUSH 255
    SHR              // [trap, d, x, s]
    SWAP2            // [trap, s, x, d]
    DUP1             // [trap, s, x, d, d]
    PUSH 255         // [trap, s, x, d, d, 255]
    LT               // [trap, s, x, d, 255 < d]
    %jumpi(sar_big)
    // himask = ones << (256 - d); note d = 0 gives ones << 256 = 0
    DUP1             // [trap, s, x, d, d]
    PUSH 256         // [trap, s, x, d, d, 256]
    SUB              // [trap, s, x, d, 256 - d]
    PUSH 0
    NOT              // [trap, s, x, d, 256-d, ones]
    SWAP1            // [trap, s, x, d, ones, 256-d]
    SHL              // [trap, s, x, d, himask]
    SWAP3            // [trap, himask, x, d, s]
    ISZERO
    %jumpi(sar_pos)
    SHR              // [trap, himask, x >> d]
    OR               // [trap, result]
    %jump(sar_fin)
sar_pos:
    SHR              // [trap, himask, x >> d]
    SWAP1
    POP              // [trap, x >> d]
sar_fin:
    SWAP1
    %charge_gas(3)
    EXIT_KERNEL
sar_big:
    // d >= 256: result = s ? ones : 0
    POP
    POP              // [trap, s]
    ISZERO
    %jumpi(sar_zero)
    PUSH 0
    NOT              // [trap, ones]
    %jump(sar_big_fin)
sar_zero:
    PUSH 0
sar_big_fin:
    SWAP1
    %charge_gas(3)
    EXIT_KERNEL
