// secp256k1 + in-kernel ecrecover (reduced twin of reference
// cpu/kernel/asm/curve/secp256k1/{curve_mul.asm,curve_add.asm,
// ecrecover.asm} + transactions sender recovery).
//
// Design: the Shamir double-and-add ladder runs in JACOBIAN coordinates
// so no per-step field inversion is needed; the only inversions are
// three nondeterministic PROVER_INPUT hints (y = sqrt(x^3+7), r^-1 mod
// n, Z^-1 mod p), each checked with one MULMOD — the host oracle is
// field/secp256k1.py ecrecover_kernel_hints, which replicates this
// file's exact formulas and branch structure.  Acc state lives in seven
// freshly-allocated TRIE cells (base in @GLOBAL_EC_BASE):
//   +0 AX  +1 AY  +2 AZ (Jacobian; AZ = 0 <=> infinity)
//   +3 QX  +4 QY  (recovered point R, affine)
//   +5 U1  +6 U2  (ladder scalars)
// Stack comments list the TOP first.

// ---- field macros: a, b are canonical (< modulus) field elements ----

%macro mulp                      // [a, b] -> [a*b mod p]
    PUSH @SECP_P
    SWAP2
    MULMOD
%endmacro

%macro addp                      // [a, b] -> [a+b mod p]
    PUSH @SECP_P
    SWAP2
    ADDMOD
%endmacro

%macro subp                      // [a, b] -> [a-b mod p]
    SWAP1
    PUSH @SECP_P
    SUB                          // [p-b, a]
    PUSH @SECP_P
    SWAP2
    ADDMOD
%endmacro

%macro muln                      // [a, b] -> [a*b mod n]
    PUSH @SECP_N
    SWAP2
    MULMOD
%endmacro

%macro ec_load(slot)             // [..] -> [TRIE[base+slot], ..]
    %mload_global(@GLOBAL_EC_BASE)
    PUSH $slot
    ADD
    %trie_read
%endmacro

%macro ec_store(slot)            // [value, ..] -> [..]
    %mload_global(@GLOBAL_EC_BASE)
    PUSH $slot
    ADD
    %trie_write
%endmacro

// ---- ec_double_acc(retdest): acc = 2*acc (dbl-2009-l; infinity-safe:
// AZ = 0 propagates through Z3 = 2*AY*AZ) ----
global ec_double_acc:
    // stack: retdest
    %ec_load(0)
    DUP1
    %mulp                        // [A = AX^2]
    %ec_load(1)
    DUP1
    %mulp                        // [B, A]
    DUP1
    DUP1
    %mulp                        // [C = B^2, B, A]
    DUP2
    %ec_load(0)
    %addp                        // [AX+B, C, B, A]
    DUP1
    %mulp                        // [(AX+B)^2, C, B, A]
    DUP4
    SWAP1
    %subp                        // [(AX+B)^2-A, C, B, A]
    DUP2
    SWAP1
    %subp                        // [t, C, B, A]  (t = (AX+B)^2-A-C)
    DUP1
    %addp                        // [D = 2t, C, B, A]
    DUP4
    DUP1
    %addp                        // [2A, D, C, B, A]
    DUP5
    %addp                        // [E = 3A, D, C, B, A]
    DUP1
    DUP1
    %mulp                        // [F = E^2, E, D, C, B, A]
    DUP3
    DUP1
    %addp                        // [2D, F, E, D, C, B, A]
    SWAP1
    %subp                        // [X3 = F-2D, E, D, C, B, A]
    DUP1
    DUP4                         // [D, X3, X3, E, D, C, B, A]
    %subp                        // [D-X3, X3, E, D, C, B, A]
    DUP3
    %mulp                        // [E*(D-X3), X3, E, D, C, B, A]
    DUP5
    DUP1
    %addp
    DUP1
    %addp
    DUP1
    %addp                        // [8C, E*(D-X3), X3, E, D, C, B, A]
    SWAP1
    %subp                        // [Y3, X3, E, D, C, B, A]
    %ec_load(1)
    %ec_load(2)
    %mulp                        // [AY*AZ, Y3, X3, E, D, C, B, A]
    DUP1
    %addp                        // [Z3, Y3, X3, E, D, C, B, A]
    %ec_store(2)
    %ec_store(1)
    %ec_store(0)                 // [E, D, C, B, A, retdest]
    %stack (e, d, c, b, a) -> ()
    JUMP

// ---- ec_add_acc(x2, y2, retdest): acc += (x2, y2) (madd-2007-bl,
// mixed Jacobian+affine; handles acc = infinity, equal and opposite
// points by branching exactly like the host twin) ----
global ec_add_acc:
    // stack: x2, y2, retdest
    %ec_load(2)
    ISZERO
    %jumpi(ec_add_set)
    %ec_load(2)
    DUP1
    %mulp                        // [Z1Z1, x2, y2, r]
    DUP1
    DUP3
    %mulp                        // [U2 = x2*Z1Z1, Z1Z1, x2, y2, r]
    DUP2
    %ec_load(2)
    %mulp                        // [AZ*Z1Z1, U2, Z1Z1, x2, y2, r]
    DUP5
    %mulp                        // [S2 = y2*AZ*Z1Z1, U2, Z1Z1, x2, y2, r]
    DUP2
    %ec_load(0)
    SWAP1
    %subp                        // [H = U2-AX, S2, U2, Z1Z1, x2, y2, r]
    DUP2
    %ec_load(1)
    SWAP1
    %subp                        // [S2-AY, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    %addp                        // [rr = 2(S2-AY), H, S2, U2, Z1Z1, x2, y2, r]
    DUP2
    ISZERO
    %jumpi(ec_add_degenerate)
    DUP2
    DUP1
    %mulp                        // [HH, rr, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    %addp
    DUP1
    %addp                        // [I = 4HH, rr, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    DUP4
    %mulp                        // [J = H*I, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    %ec_load(0)
    DUP3
    %mulp                        // [V = AX*I, J, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    DUP4
    DUP1
    %mulp                        // [rr^2, V, J, I, rr, H, ...]
    DUP3
    SWAP1
    %subp                        // [rr^2-J, V, J, I, rr, H, ...]
    DUP2
    DUP1
    %addp                        // [2V, rr^2-J, V, J, I, rr, H, ...]
    SWAP1
    %subp                        // [X3, V, J, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    DUP1
    DUP3                         // [V, X3, X3, V, J, I, rr, H, ...]
    %subp                        // [V-X3, X3, V, J, I, rr, H, ...]
    DUP6
    %mulp                        // [rr*(V-X3), X3, V, J, I, rr, H, ...]
    %ec_load(1)
    DUP5
    %mulp                        // [AY*J, rr*(V-X3), X3, V, J, I, rr, H, ...]
    DUP1
    %addp                        // [2*AY*J, rr*(V-X3), X3, ...]
    SWAP1
    %subp                        // [Y3, X3, V, J, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    %ec_load(2)
    DUP8
    %mulp                        // [AZ*H, Y3, X3, V, J, I, rr, H, ...]
    DUP1
    %addp                        // [Z3, Y3, X3, V, J, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    %ec_store(2)
    %ec_store(1)
    %ec_store(0)                 // [V, J, I, rr, H, S2, U2, Z1Z1, x2, y2, r]
    %stack (v, j, i, rr, h, s2, u2, z1z1, x2, y2) -> ()
    JUMP
ec_add_degenerate:
    // stack: rr, H(=0), S2, U2, Z1Z1, x2, y2, retdest
    DUP1
    ISZERO
    %jumpi(ec_add_is_double)
    // opposite points: acc = infinity (AZ = 0, AX/AY untouched)
    %stack (rr, h, s2, u2, z1z1, x2, y2) -> (0)
    %ec_store(2)
    JUMP
ec_add_is_double:
    %stack (rr, h, s2, u2, z1z1, x2, y2) -> ()
    %jump(ec_double_acc)         // tail call; retdest already on top
ec_add_set:
    // acc was infinity: acc = (x2, y2, 1)
    // stack: x2, y2, retdest
    %ec_store(0)
    %ec_store(1)
    PUSH 1
    %ec_store(2)
    JUMP

// ---- ec_shamir(retdest): acc = U1*G + U2*Q (bits 255..0, one shared
// doubling chain — Shamir's trick) ----
global ec_shamir:
    // stack: retdest
    PUSH 256
ec_loop:
    // stack: i, retdest
    DUP1
    ISZERO
    %jumpi(ec_done)
    PUSH 1
    SWAP1
    SUB                          // [i-1, retdest]
    PUSH ec_l1
    %jump(ec_double_acc)
ec_l1:
    // stack: i, retdest
    %ec_load(5)
    DUP2
    SHR                          // [U1>>i, i, r]
    PUSH 1
    AND
    ISZERO
    %jumpi(ec_l2)
    %stack (i) -> (@SECP_GX, @SECP_GY, ec_l2, i)
    %jump(ec_add_acc)
ec_l2:
    // stack: i, retdest
    %ec_load(6)
    DUP2
    SHR
    PUSH 1
    AND
    ISZERO
    %jumpi(ec_l3)
    %ec_load(4)
    %ec_load(3)
    %stack (qx, qy, i) -> (qx, qy, ec_l3, i)
    %jump(ec_add_acc)
ec_l3:
    %jump(ec_loop)
ec_done:
    // stack: 0, retdest
    POP
    JUMP

// ---- ecrecover(hash, v, r, s, retdest) -> [address]
// PANICs on any invalid input — a block with a bad signature is
// unprovable (reference ecrecover.asm returns U256::MAX then the txn
// router aborts; our reduced flow has no fallback txn type).
global ecrecover:
    // stack: hash, v, r, s, retdest
    PUSH 7
    %trie_alloc                  // fresh zeroed scratch cells
    %mstore_global(@GLOBAL_EC_BASE)
    // 1 <= r < n
    DUP3
    ISZERO
    %jumpi(ec_bad)
    DUP3
    PUSH @SECP_N
    SWAP1
    LT                           // [r < n, ...]
    ISZERO
    %jumpi(ec_bad)
    // 1 <= s < n
    DUP4
    ISZERO
    %jumpi(ec_bad)
    DUP4
    PUSH @SECP_N
    SWAP1
    LT
    ISZERO
    %jumpi(ec_bad)
    // v in {27, 28}
    DUP2
    PUSH 27
    EQ
    DUP3
    PUSH 28
    EQ
    OR
    ISZERO
    %jumpi(ec_bad)
    // y_sq = r^3 + 7
    DUP3
    DUP1
    %mulp
    DUP4
    %mulp                        // [r^3, hash, v, r, s, rd]
    PUSH 7
    %addp                        // [ysq, hash, v, r, s, rd]
    // y hint: on-curve + parity checked
    PROVER_INPUT                 // [y, ysq, hash, v, r, s, rd]
    DUP1
    PUSH @SECP_P
    SWAP1
    LT                           // [y < p, y, ysq, ...]
    ISZERO
    %jumpi(ec_bad)
    DUP1
    DUP1
    %mulp                        // [y^2, y, ysq, ...]
    DUP3
    EQ
    ISZERO
    %jumpi(ec_bad)
    DUP1
    PUSH 1
    AND                          // [y&1, y, ysq, hash, v, r, s, rd]
    DUP5
    PUSH 27
    SWAP1
    SUB                          // [v-27, y&1, y, ysq, hash, v, r, s, rd]
    EQ
    ISZERO
    %jumpi(ec_bad)
    // Q = (r, y)
    %ec_store(4)                 // QY = y ; [ysq, hash, v, r, s, rd]
    POP                          // [hash, v, r, s, rd]
    DUP3
    %ec_store(3)                 // QX = r
    // r_inv hint (mod n)
    PROVER_INPUT                 // [rinv, hash, v, r, s, rd]
    DUP1
    DUP5
    %muln                        // [r*rinv mod n, rinv, hash, v, r, s, rd]
    PUSH 1
    EQ
    ISZERO
    %jumpi(ec_bad)
    // U1 = (n - hash mod n) * rinv mod n
    DUP2
    PUSH @SECP_N
    SWAP1
    MOD                          // [hash mod n, rinv, hash, v, r, s, rd]
    PUSH @SECP_N
    SUB                          // [n - hash mod n, rinv, ...]
    DUP2
    %muln                        // [U1, rinv, hash, v, r, s, rd]
    %ec_store(5)
    // U2 = s * rinv mod n
    DUP5
    %muln                        // [U2, hash, v, r, s, rd]
    %ec_store(6)
    // acc = infinity; ladder
    PUSH 0
    %ec_store(2)
    %stack (hash, v, r, s) -> (ec_rec1)
    %jump(ec_shamir)
ec_rec1:
    // stack: retdest
    %ec_load(2)
    ISZERO
    %jumpi(ec_bad)               // recovered infinity: invalid signature
    // z_inv hint; normalize to affine
    PROVER_INPUT                 // [zinv, rd]
    DUP1
    %ec_load(2)
    %mulp                        // [Z*zinv, zinv, rd]
    PUSH 1
    EQ
    ISZERO
    %jumpi(ec_bad)
    DUP1
    DUP1
    %mulp                        // [zinv^2, zinv, rd]
    DUP1
    DUP3
    %mulp                        // [zinv^3, zinv2, zinv, rd]
    %ec_load(1)
    %mulp                        // [y_aff, zinv2, zinv, rd]
    SWAP1
    %ec_load(0)
    %mulp                        // [x_aff, y_aff, zinv, rd]
    // address = keccak256(x || y)[12:]
    PUSH 64
    %rlp_alloc                   // [buf, x, y, zinv, rd]
    %stack (buf, x, y) -> (buf, x, 32, ec_rec2, buf, y)
    %jump(mstore_be)
ec_rec2:
    // stack: buf, y, zinv, rd
    DUP1
    PUSH 32
    ADD                          // [buf+32, buf, y, zinv, rd]
    %stack (b32, buf, y) -> (b32, y, 32, ec_rec3, buf)
    %jump(mstore_be)
ec_rec3:
    // stack: buf, zinv, rd
    %stack (buf) -> (@SEGMENT_RLP, buf, 64)
    KECCAK_GENERAL               // [digest_le, zinv, rd]
    %stack (d) -> (d, ec_rec4)
    %jump(byteswap32)
ec_rec4:
    // stack: digest_be, zinv, rd
    PUSH 0xffffffffffffffffffffffffffffffffffffffff
    AND                          // [address, zinv, rd]
    SWAP1
    POP                          // [address, rd]
    SWAP1
    JUMP
ec_bad:
    %jump(panic)

// ---- verify_txn_signature(retdest): recover the sender from the txn
// signature (SEG_GLOBAL v/r/s slots) over keccak(unsigned txn RLP) and
// PANIC unless it equals the claimed @GLOBAL_TXN_SENDER.  SIG_R = 0
// means an unsigned txn (the round-2 reduction) — skipped, documented
// in kernel/aggregator.py. ----
global verify_txn_signature:
    // stack: retdest
    %mload_global(@GLOBAL_TXN_SIG_R)
    ISZERO
    %jumpi(vts_skip)
    PUSH vts_1
    %jump(build_txn_value)
vts_1:
    // stack: vptr ([len, b0..] trie bytes-value), retdest
    DUP1
    %trie_read                   // [len, vptr, rd]
    SWAP1
    PUSH 1
    ADD                          // [vptr+1, len, rd]
    %stack (a, l) -> (@SEGMENT_TRIE, a, l)
    KECCAK_GENERAL               // [sighash_le, rd]
    %stack (d) -> (d, vts_2)
    %jump(byteswap32)
vts_2:
    // stack: sighash, retdest
    %mload_global(@GLOBAL_TXN_SIG_S)
    %mload_global(@GLOBAL_TXN_SIG_R)
    %mload_global(@GLOBAL_TXN_SIG_V)
    %stack (v, r, s, h) -> (h, v, r, s, vts_3)
    %jump(ecrecover)
vts_3:
    // stack: recovered, retdest
    %mload_global(@GLOBAL_TXN_SENDER)
    EQ
    ISZERO
    %jumpi(panic)                // forged signature: unprovable
vts_skip:
    JUMP
