// BN254 (alt_bn128) curve ops + the 0x06/0x07 precompiles (twin of
// reference cpu/kernel/asm/curve/bn254/{curve_add.asm,curve_mul.asm}
// + core/precompiles/{bn_add.asm,bn_mul.asm}).
//
// Field arithmetic rides the dedicated ADDFP254 / MULFP254 / SUBFP254
// natives (arithmetic.py BN_BASE lanes), so a field op is ONE cycle —
// no MULMOD modulus juggling.  Points use Jacobian coordinates
// (AZ = 0 <=> infinity) in three fresh TRIE cells at @GLOBAL_EC_BASE:
//   +0 AX  +1 AY  +2 AZ
// The final affinization uses one nondeterministic Z^-1 hint from the
// PROVER_INPUT stream, checked with one MULFP254 == 1 (host oracle:
// zkevm/bn254.py bn_add_kernel_hints / bn_mul_kernel_hints, which
// replay these exact formulas).  Invalid inputs (coordinate >= p, or a
// point off y^2 = x^3 + 3) PANIC — the reference fails the call; here
// the block is unprovable instead (same reduction as the other
// precompile error paths, precompiles.asm note).
//
// Stack comments list the TOP first.

%macro bn_load(slot)             // [..] -> [TRIE[base+slot], ..]
    %mload_global(@GLOBAL_EC_BASE)
    PUSH $slot
    ADD
    %trie_read
%endmacro

%macro bn_store(slot)            // [value, ..] -> [..]
    %mload_global(@GLOBAL_EC_BASE)
    PUSH $slot
    ADD
    %trie_write
%endmacro

// [x, y] -> [] : PANIC unless (x, y) is on the curve or the point at
// infinity encoded as (0, 0); coordinates must be canonical (< p).
global bn_check_point:
    // stack: x, y, retdest
    DUP1
    PUSH @BN_P
    GT                           // [p > x, x, y, retdest]
    ISZERO
    %jumpi(panic)
    DUP2
    PUSH @BN_P
    GT
    ISZERO
    %jumpi(panic)
    DUP2
    DUP2
    OR
    ISZERO
    %jumpi(bn_cp_inf)            // (0,0) = infinity: fine
    // y^2 == x^3 + 3 ?
    DUP2
    DUP1
    MULFP254                     // [y^2, x, y, retdest]
    DUP2
    DUP1
    MULFP254
    DUP3
    MULFP254                     // [x^3, y^2, x, y, retdest]
    PUSH 3
    ADDFP254                     // [x^3+3, y^2, x, y, retdest]
    EQ
    ISZERO
    %jumpi(panic)
    POP
    POP
    JUMP
bn_cp_inf:
    POP
    POP
    JUMP

// bn_double_acc(retdest): acc = 2*acc (dbl-2009-l, a = 0;
// infinity-safe: AZ = 0 propagates through Z3 = 2*AY*AZ).
global bn_double_acc:
    // stack: retdest
    %bn_load(0)
    DUP1
    MULFP254                     // [A = AX^2]
    %bn_load(1)
    DUP1
    MULFP254                     // [B = AY^2, A]
    DUP1
    DUP1
    MULFP254                     // [C = B^2, B, A]
    DUP2
    %bn_load(0)
    ADDFP254                     // [AX+B, C, B, A]
    DUP1
    MULFP254                     // [(AX+B)^2, C, B, A]
    DUP4
    SWAP1
    SUBFP254                     // [(AX+B)^2-A, C, B, A]
    DUP2
    SWAP1
    SUBFP254                     // [t = (AX+B)^2-A-C, C, B, A]
    DUP1
    ADDFP254                     // [D = 2t, C, B, A]
    DUP4
    DUP1
    ADDFP254                     // [2A, D, C, B, A]
    DUP5
    ADDFP254                     // [E = 3A, D, C, B, A]
    DUP1
    DUP1
    MULFP254                     // [F = E^2, E, D, C, B, A]
    DUP3
    DUP1
    ADDFP254                     // [2D, F, E, D, C, B, A]
    SWAP1
    SUBFP254                     // [X3 = F-2D, E, D, C, B, A]
    DUP1
    DUP4                         // [D, X3, X3, E, D, C, B, A]
    SUBFP254                     // [D-X3, X3, E, D, C, B, A]
    DUP3
    MULFP254                     // [E*(D-X3), X3, E, D, C, B, A]
    DUP5
    DUP1
    ADDFP254
    DUP1
    ADDFP254
    DUP1
    ADDFP254                     // [8C, E*(D-X3), X3, E, D, C, B, A]
    SWAP1
    SUBFP254                     // [Y3, X3, E, D, C, B, A]
    %bn_load(1)
    %bn_load(2)
    MULFP254                     // [AY*AZ, Y3, X3, E, D, C, B, A]
    DUP1
    ADDFP254                     // [Z3, Y3, X3, E, D, C, B, A]
    %bn_store(2)
    %bn_store(1)
    %bn_store(0)
    %stack (e, d, c, b, a) -> ()
    JUMP

// bn_add_acc(x2, y2, retdest): acc += (x2, y2) (madd-2007-bl, mixed
// Jacobian + affine; (x2, y2) must NOT be infinity — callers skip).
global bn_add_acc:
    // stack: x2, y2, retdest
    %bn_load(2)
    ISZERO
    %jumpi(bn_add_set)
    %bn_load(2)
    DUP1
    MULFP254                     // [Z1Z1, x2, y2, r]
    DUP1
    DUP3
    MULFP254                     // [U2 = x2*Z1Z1, Z1Z1, x2, y2, r]
    DUP2
    %bn_load(2)
    MULFP254                     // [AZ*Z1Z1, U2, Z1Z1, x2, y2, r]
    DUP5
    MULFP254                     // [S2 = y2*AZ*Z1Z1, U2, Z1Z1, x2, y2, r]
    DUP2
    %bn_load(0)
    SWAP1
    SUBFP254                     // [H = U2-AX, S2, U2, Z1Z1, x2, y2, r]
    DUP2
    %bn_load(1)
    SWAP1
    SUBFP254                     // [S2-AY, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    ADDFP254                     // [rr = 2(S2-AY), H, S2, U2, Z1Z1, x2, y2, r]
    DUP2
    ISZERO
    %jumpi(bn_add_degenerate)
    DUP2
    DUP1
    MULFP254                     // [HH, rr, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    ADDFP254
    DUP1
    ADDFP254                     // [I = 4HH, rr, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    DUP4
    MULFP254                     // [J = H*I, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    %bn_load(0)
    DUP3
    MULFP254                     // [V = AX*I, J, I, rr, H, ...]
    DUP4
    DUP1
    MULFP254                     // [rr^2, V, J, I, rr, H, ...]
    DUP3
    SWAP1
    SUBFP254                     // [rr^2-J, V, J, I, rr, H, ...]
    DUP2
    DUP1
    ADDFP254                     // [2V, rr^2-J, V, J, I, rr, H, ...]
    SWAP1
    SUBFP254                     // [X3, V, J, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    DUP3                         // [V, X3, X3, V, J, I, rr, H, ...]
    SUBFP254                     // [V-X3, X3, V, J, I, rr, H, ...]
    DUP6
    MULFP254                     // [rr*(V-X3), X3, V, J, I, rr, H, ...]
    %bn_load(1)
    DUP5
    MULFP254                     // [AY*J, rr*(V-X3), X3, ...]
    DUP1
    ADDFP254                     // [2*AY*J, rr*(V-X3), X3, ...]
    SWAP1
    SUBFP254                     // [Y3, X3, V, J, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    %bn_load(2)
    DUP8
    MULFP254                     // [AZ*H, Y3, X3, ...]
    DUP1
    ADDFP254                     // [Z3, Y3, X3, V, J, I, rr, H, Z1Z1... ]
    %bn_store(2)
    %bn_store(1)
    %bn_store(0)
    %stack (v, j, i, rr, h, s2, u2, z1z1, x2, y2) -> ()
    JUMP
bn_add_degenerate:
    // stack: rr, H(=0), S2, U2, Z1Z1, x2, y2, retdest
    DUP1
    ISZERO
    %jumpi(bn_add_is_double)
    // opposite points: acc = infinity
    %stack (rr, h, s2, u2, z1z1, x2, y2) -> (0)
    %bn_store(2)
    JUMP
bn_add_is_double:
    %stack (rr, h, s2, u2, z1z1, x2, y2) -> ()
    %jump(bn_double_acc)
bn_add_set:
    // acc was infinity: acc = (x2, y2, 1)
    %bn_store(0)
    %bn_store(1)
    PUSH 1
    %bn_store(2)
    JUMP

// bn_affinize(retdest) -> (x, y): read acc, divide by Z^2/Z^3 using a
// checked PROVER_INPUT inverse hint; infinity encodes as (0, 0).
global bn_affinize:
    // stack: retdest
    %bn_load(2)
    ISZERO
    %jumpi(bn_aff_inf)
    PROVER_INPUT                 // [zinv, retdest]
    DUP1
    %bn_load(2)
    MULFP254                     // [z*zinv, zinv, retdest]
    PUSH 1
    EQ
    ISZERO
    %jumpi(panic)                // bad hint: unprovable
    DUP1
    DUP1
    MULFP254                     // [zi2, zinv, retdest]
    DUP1
    %bn_load(0)
    MULFP254                     // [x = AX*zi2, zi2, zinv, retdest]
    SWAP2                        // [zinv, zi2, x, retdest]
    MULFP254                     // [zi3, x, retdest]
    %bn_load(1)
    MULFP254                     // [y = AY*zi3, x, retdest]
    SWAP1                        // [x, y, retdest]
    %stack (x, y, retdest) -> (retdest, x, y)
    JUMP
bn_aff_inf:
    %stack (retdest) -> (retdest, 0, 0)
    JUMP

// ---- 0x06 bn_add: input [x1 y1 x2 y2] (4 x 32 BE bytes, zero-padded
// reads); output = 64-byte point.
global pc_bn_add:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    PUSH 3
    %trie_alloc                  // fresh (AX, AY, AZ) cells — all zero
    %mstore_global(@GLOBAL_EC_BASE)
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)      // [bsw, trap, value, ao, asz, ro, rs]
    DUP4
    %stack (ao, bsw) -> (bsw, ao, 32, pba_1, bsw)
    %jump(mload_be_gen)
pba_1:
    // stack: x1, bsw, trap, value, ao, asz, ro, rs
    DUP2
    DUP6
    PUSH 32
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pba_2)
    %jump(mload_be_gen)
pba_2:
    // stack: y1, x1, bsw, trap, value, ao, asz, ro, rs
    DUP3
    DUP7
    PUSH 64
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pba_3)
    %jump(mload_be_gen)
pba_3:
    // stack: x2, y1, x1, bsw, trap, value, ao, asz, ro, rs
    DUP4
    DUP8
    PUSH 96
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pba_4)
    %jump(mload_be_gen)
pba_4:
    // stack: y2, x2, y1, x1, bsw, trap, value, ao, asz, ro, rs
    DUP4
    DUP4
    %stack (y1, x1) -> (x1, y1, pba_5)
    %jump(bn_check_point)
pba_5:
    // stack: y2, x2, y1, x1, bsw, trap, ...
    DUP2
    DUP2
    SWAP1
    %stack (x2, y2) -> (x2, y2, pba_6)
    %jump(bn_check_point)
pba_6:
    // stack: y2, x2, y1, x1, bsw, trap, value, ao, asz, ro, rs
    // acc = P1 unless P1 = (0,0)
    DUP4
    DUP4
    OR
    ISZERO
    %jumpi(pba_p2)
    DUP4
    %bn_store(0)
    DUP3
    %bn_store(1)
    PUSH 1
    %bn_store(2)
pba_p2:
    // add P2 unless (0,0)
    DUP2
    DUP2
    OR
    ISZERO
    %jumpi(pba_out)
    DUP2
    DUP2
    SWAP1
    %stack (x2, y2) -> (x2, y2, pba_out)
    %jump(bn_add_acc)
pba_out:
    // stack: y2, x2, y1, x1, bsw, trap, value, ao, asz, ro, rs
    %stack (y2, x2, y1, x1, bsw) -> (pba_7)
    %jump(bn_affinize)
pba_7:
    // stack: x, y, trap, value, ao, asz, ro, rs
    %stack (x) -> (@SEGMENT_RETURNDATA, 0, x, 32, pba_8)
    %jump(mstore_be_gen)
pba_8:
    // stack: y, trap, value, ao, asz, ro, rs
    %stack (y) -> (@SEGMENT_RETURNDATA, 32, y, 32, pba_9)
    %jump(mstore_be_gen)
pba_9:
    PUSH 64
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %jump(pc_done)

// ---- 0x07 bn_mul: input [x y s] (3 x 32 BE bytes); output = s*(x,y).
global pc_bn_mul:
    // stack: addr, trap, value, ao, asz, ro, rs
    POP
    PUSH 3
    %trie_alloc
    %mstore_global(@GLOBAL_EC_BASE)
    GET_CONTEXT
    %seg_of(@SEGMENT_BYTES)
    DUP4
    %stack (ao, bsw) -> (bsw, ao, 32, pbm_1, bsw)
    %jump(mload_be_gen)
pbm_1:
    // stack: x, bsw, trap, value, ao, asz, ro, rs
    DUP2
    DUP6
    PUSH 32
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pbm_2)
    %jump(mload_be_gen)
pbm_2:
    // stack: y, x, bsw, trap, value, ao, asz, ro, rs
    DUP3
    DUP7
    PUSH 64
    ADD
    %stack (a, bsw) -> (bsw, a, 32, pbm_3)
    %jump(mload_be_gen)
pbm_3:
    // stack: s, y, x, bsw, trap, value, ao, asz, ro, rs
    DUP3
    DUP3
    %stack (y, x) -> (x, y, pbm_4)
    %jump(bn_check_point)
pbm_4:
    // stack: s, y, x, bsw, trap, ...
    // infinity input: result is infinity regardless of s
    DUP3
    DUP3
    OR
    ISZERO
    %jumpi(pbm_out)
    // double-and-add, bits 255..0
    PUSH 256
pbm_loop:
    // stack: i, s, y, x, bsw, trap, value, ao, asz, ro, rs
    DUP1
    ISZERO
    %jumpi(pbm_out_i)
    PUSH 1
    SWAP1
    SUB                          // [i-1, s, y, x, ...]
    PUSH pbm_l1
    %jump(bn_double_acc)
pbm_l1:
    // stack: i, s, y, x, bsw, trap, ...
    DUP2
    DUP2
    SHR
    PUSH 1
    AND
    ISZERO
    %jumpi(pbm_loop)
    DUP4
    DUP4
    SWAP1
    %stack (x, y) -> (x, y, pbm_loop_ret)
    %jump(bn_add_acc)
pbm_loop_ret:
    %jump(pbm_loop)
pbm_out_i:
    POP                          // drop i
pbm_out:
    // stack: [i]?, s, y, x, bsw, trap, value, ao, asz, ro, rs
    %stack (s, y, x, bsw) -> (pbm_5)
    %jump(bn_affinize)
pbm_5:
    // stack: x, y, trap, value, ao, asz, ro, rs
    %stack (x) -> (@SEGMENT_RETURNDATA, 0, x, 32, pbm_6)
    %jump(mstore_be_gen)
pbm_6:
    %stack (y) -> (@SEGMENT_RETURNDATA, 32, y, 32, pbm_7)
    %jump(mstore_be_gen)
pbm_7:
    PUSH 64
    %mstore_global(@GLOBAL_RETURNDATA_LEN)
    %jump(pc_done)
