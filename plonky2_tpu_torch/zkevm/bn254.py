"""BN254 extension tower and Tate pairing (twin of reference
evm/src/extension_tower.rs + curve_pairings.rs).

Tower: Fp2 = Fp[i]/(i^2 + 1), Fp6 = Fp2[t]/(t^3 - xi) with xi = 9 + i,
Fp12 = Fp6[z]/(z^2 - t).  Frobenius maps use the identities
t^(p^n) = t * xi^((p^n - 1)/3) and z^(p^n) = z * xi^((p^n - 1)/6);
the constants are *computed* at import (exact bigint pow) rather than
hard-coded like the reference's FROB_T/FROB_Z tables
(extension_tower.rs:400-800).

Pairing: Tate — Miller loop over the group order with tangent/cord line
functions in sparse Fp12 embedding (curve_pairings.rs:198-258), then the
final exponentiation split into the frobenius "easy part" and a plain
(p^4 - p^2 + 1)/N "hard part" power (curve_pairings.rs:279; the
reference's custom addition-chain is a CPU-side optimisation we don't
need host-side).

Pure-Python bigints: this is witness-generation / verification support
for the EVM pairing precompile, not a proving hot path.
"""

from __future__ import annotations

from dataclasses import dataclass

# base field and curve order
BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN_N = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _inv(x: int) -> int:
    return pow(x, BN_P - 2, BN_P)


@dataclass(frozen=True)
class Fp2:
    re: int
    im: int

    def __add__(s, o):
        return Fp2((s.re + o.re) % BN_P, (s.im + o.im) % BN_P)

    def __sub__(s, o):
        return Fp2((s.re - o.re) % BN_P, (s.im - o.im) % BN_P)

    def __neg__(s):
        return Fp2(-s.re % BN_P, -s.im % BN_P)

    def __mul__(s, o):
        if isinstance(o, int):
            return Fp2(s.re * o % BN_P, s.im * o % BN_P)
        return Fp2((s.re * o.re - s.im * o.im) % BN_P,
                   (s.re * o.im + s.im * o.re) % BN_P)

    __rmul__ = __mul__

    def conj(s):
        return Fp2(s.re, -s.im % BN_P)

    def inv(s):
        n = _inv((s.re * s.re + s.im * s.im) % BN_P)
        return Fp2(s.re * n % BN_P, -s.im * n % BN_P)

    def pow(s, e: int) -> "Fp2":
        r, b = FP2_ONE, s
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
        return r

    def frob(s, n: int) -> "Fp2":
        return s if n % 2 == 0 else s.conj()

    def is_zero(s) -> bool:
        return s.re == 0 and s.im == 0


FP2_ZERO = Fp2(0, 0)
FP2_ONE = Fp2(1, 0)
XI = Fp2(9, 1)  # the cubic non-residue adjoined by Fp6

# frobenius constants: t^(p^n) = t * FROB_T1[n], t^2(p^n) = t^2 * FROB_T2[n],
# z^(p^n) = z * FROB_Z[n]
FROB_T1 = [XI.pow((pow(BN_P, n) - 1) // 3) for n in range(6)]
FROB_T2 = [XI.pow(2 * (pow(BN_P, n) - 1) // 3) for n in range(6)]
FROB_Z = [XI.pow((pow(BN_P, n) - 1) // 6) for n in range(12)]


@dataclass(frozen=True)
class Fp6:
    t0: Fp2
    t1: Fp2
    t2: Fp2

    def __add__(s, o):
        return Fp6(s.t0 + o.t0, s.t1 + o.t1, s.t2 + o.t2)

    def __sub__(s, o):
        return Fp6(s.t0 - o.t0, s.t1 - o.t1, s.t2 - o.t2)

    def __neg__(s):
        return Fp6(-s.t0, -s.t1, -s.t2)

    def __mul__(s, o):
        if isinstance(o, Fp2):
            return Fp6(s.t0 * o, s.t1 * o, s.t2 * o)
        # schoolbook with reduction t^3 = xi (extension_tower.rs:892)
        c0 = s.t0 * o.t0 + (s.t1 * o.t2 + s.t2 * o.t1) * XI
        c1 = s.t0 * o.t1 + s.t1 * o.t0 + s.t2 * o.t2 * XI
        c2 = s.t0 * o.t2 + s.t1 * o.t1 + s.t2 * o.t0
        return Fp6(c0, c1, c2)

    def sh(s):
        """Multiply by t (extension_tower.rs:925)."""
        return Fp6(s.t2 * XI, s.t0, s.t1)

    def frob(s, n: int) -> "Fp6":
        return Fp6(s.t0.frob(n), s.t1.frob(n) * FROB_T1[n % 6],
                   s.t2.frob(n) * FROB_T2[n % 6])

    def inv(s) -> "Fp6":
        # via the adjugate: c_i of s^-1 = adj_i / det
        a, b, c = s.t0, s.t1, s.t2
        c0 = a * a - b * c * XI
        c1 = c * c * XI - a * b
        c2 = b * b - a * c
        det = a * c0 + (c * c1 + b * c2) * XI
        dinv = det.inv()
        return Fp6(c0 * dinv, c1 * dinv, c2 * dinv)

    def is_zero(s) -> bool:
        return s.t0.is_zero() and s.t1.is_zero() and s.t2.is_zero()


FP6_ZERO = Fp6(FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = Fp6(FP2_ONE, FP2_ZERO, FP2_ZERO)


@dataclass(frozen=True)
class Fp12:
    z0: Fp6
    z1: Fp6

    def __mul__(s, o):
        # z^2 = t (extension_tower.rs:1153)
        h0 = s.z0 * o.z0 + (s.z1 * o.z1).sh()
        h1 = s.z0 * o.z1 + s.z1 * o.z0
        return Fp12(h0, h1)

    def conj(s):
        return Fp12(s.z0, -s.z1)

    def frob(s, n: int) -> "Fp12":
        return Fp12(s.z0.frob(n), s.z1.frob(n) * FROB_Z[n % 12])

    def inv(s) -> "Fp12":
        # (z0 + z1 z)^-1 = (z0 - z1 z) / (z0^2 - z1^2 t)
        det = s.z0 * s.z0 - (s.z1 * s.z1).sh()
        dinv = det.inv()
        return Fp12(s.z0 * dinv, -(s.z1 * dinv))

    def pow(s, e: int) -> "Fp12":
        r, b = FP12_ONE, s
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
        return r

    def __truediv__(s, o):
        return s * o.inv()

    def __eq__(s, o):
        return s.z0 == o.z0 and s.z1 == o.z1


FP12_ONE = Fp12(FP6_ONE, FP6_ZERO)


# ---------------------------------------------------------------- curves

@dataclass(frozen=True)
class CurvePoint:
    """Affine point; (None, None) is the identity (curve_pairings.rs:11)."""

    x: object = None
    y: object = None

    def is_identity(s) -> bool:
        return s.x is None


# G1: y^2 = x^3 + 3 over Fp (ints); G2: y^2 = x^3 + 3/xi over Fp2
G1_GEN = CurvePoint(1, 2)
G2_GEN = CurvePoint(
    Fp2(10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634),
    Fp2(8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531))


def g1_is_on_curve(p: CurvePoint) -> bool:
    if p.is_identity():
        return True
    return (p.y * p.y - p.x ** 3 - 3) % BN_P == 0


def g2_is_on_curve(p: CurvePoint) -> bool:
    if p.is_identity():
        return True
    b2 = Fp2(3, 0) * XI.inv()
    lhs = p.y * p.y
    rhs = p.x * p.x * p.x + b2
    return (lhs - rhs).is_zero()


def _add(p: CurvePoint, q: CurvePoint, field_inv) -> CurvePoint:
    if p.is_identity():
        return q
    if q.is_identity():
        return p
    if p.x == q.x:
        py_neg = (-q.y % BN_P) if isinstance(q.y, int) else -q.y
        if p.y == py_neg:
            return CurvePoint()
        # doubling
        num = 3 * p.x * p.x if isinstance(p.x, int) else p.x * p.x * 3
        den = 2 * p.y if isinstance(p.y, int) else p.y * 2
    else:
        num = p.y - q.y if not isinstance(p.y, int) else (p.y - q.y)
        den = p.x - q.x if not isinstance(p.x, int) else (p.x - q.x)
    if isinstance(p.x, int):
        lam = num % BN_P * field_inv(den % BN_P) % BN_P
        x = (lam * lam - p.x - q.x) % BN_P
        y = (lam * (p.x - x) - p.y) % BN_P
    else:
        lam = num * den.inv()
        x = lam * lam - p.x - q.x
        y = lam * (p.x - x) - p.y
    return CurvePoint(x, y)


def curve_add(p: CurvePoint, q: CurvePoint) -> CurvePoint:
    return _add(p, q, _inv)


def curve_mul(p: CurvePoint, k: int) -> CurvePoint:
    r = CurvePoint()
    b = p
    while k:
        if k & 1:
            r = curve_add(r, b)
        b = curve_add(b, b)
        k >>= 1
    return r


# --------------------------------------------------------------- pairing

def _sparse_embed(g000: int, g01: Fp2, g11: Fp2) -> Fp12:
    """(curve_pairings.rs:240 bn_sparse_embed)"""
    g0 = Fp6(Fp2(g000 % BN_P, 0), g01, FP2_ZERO)
    g1 = Fp6(FP2_ZERO, g11, FP2_ZERO)
    return Fp12(g0, g1)


def _tangent(p: CurvePoint, q: CurvePoint) -> Fp12:
    """(curve_pairings.rs:225)"""
    cx = -3 * p.x * p.x % BN_P
    cy = 2 * p.y % BN_P
    return _sparse_embed(p.y * p.y - 9, q.x * cx, q.y * cy)


def _cord(p1: CurvePoint, p2: CurvePoint, q: CurvePoint) -> Fp12:
    """(curve_pairings.rs:232)"""
    cx = (p2.y - p1.y) % BN_P
    cy = (p1.x - p2.x) % BN_P
    return _sparse_embed(p1.y * p2.x - p2.y * p1.x, q.x * cx, q.y * cy)


def miller_loop(p: CurvePoint, q: CurvePoint) -> Fp12:
    """(curve_pairings.rs:206 bn_miller_loop) — loop over the group
    order's bits below the leading one."""
    r = p
    acc = FP12_ONE
    for bit in bin(BN_N)[3:]:
        line = _tangent(r, q)
        r = curve_add(r, r)
        acc = line * acc * acc
        if bit == "1":
            line = _cord(p, r, q)
            r = curve_add(r, p)
            acc = line * acc
    return acc


def final_exponent(f: Fp12) -> Fp12:
    """(curve_pairings.rs:279 bn_final_exponent) — frobenius easy part,
    then the (p^4 - p^2 + 1)/N hard part as a plain power."""
    y = f.frob(6) / f          # ^(p^6 - 1)
    y = y.frob(2) * y          # ^(p^2 + 1)
    hard = (pow(BN_P, 4) - pow(BN_P, 2) + 1) // BN_N
    assert (pow(BN_P, 4) - pow(BN_P, 2) + 1) % BN_N == 0
    return y.pow(hard)


def tate(p: CurvePoint, q: CurvePoint) -> Fp12:
    """(curve_pairings.rs:198 bn_tate)"""
    if p.is_identity() or q.is_identity():
        return FP12_ONE
    return final_exponent(miller_loop(p, q))


# ------------------------------------------------------------------
# G1 Jacobian helpers + the 0x06/0x07 precompile hint oracles
# (kernel/asm/bn_curve.asm replays these exact formulas; the single
# nondeterministic hint per call is the final Z inverse)

def _jac_double(acc):
    """dbl-2009-l with a = 0 (bn_curve.asm bn_double_acc)."""
    X, Y, Z = acc
    A = X * X % BN_P
    B = Y * Y % BN_P
    C = B * B % BN_P
    t = ((X + B) * (X + B) - A - C) % BN_P
    D = 2 * t % BN_P
    E = 3 * A % BN_P
    F = E * E % BN_P
    X3 = (F - 2 * D) % BN_P
    Y3 = (E * (D - X3) - 8 * C) % BN_P
    Z3 = 2 * Y * Z % BN_P
    return (X3, Y3, Z3)


def _jac_add_affine(acc, x2, y2):
    """madd-2007-bl (bn_curve.asm bn_add_acc)."""
    X, Y, Z = acc
    if Z == 0:
        return (x2, y2, 1)
    Z1Z1 = Z * Z % BN_P
    U2 = x2 * Z1Z1 % BN_P
    S2 = y2 * Z * Z1Z1 % BN_P
    H = (U2 - X) % BN_P
    rr = 2 * (S2 - Y) % BN_P
    if H == 0:
        if rr == 0:
            return _jac_double(acc)
        return (X, Y, 0)
    I = 4 * H * H % BN_P
    J = H * I % BN_P
    V = X * I % BN_P
    X3 = (rr * rr - J - 2 * V) % BN_P
    Y3 = (rr * (V - X3) - 2 * Y * J) % BN_P
    Z3 = 2 * Z * H % BN_P
    return (X3, Y3, Z3)


def _jac_affinize(acc):
    X, Y, Z = acc
    if Z == 0:
        return (0, 0)
    zi = pow(Z, BN_P - 2, BN_P)
    return (X * zi * zi % BN_P, Y * zi * zi * zi % BN_P)


def bn_add_result(p1, p2):
    """Affine p1 + p2, each (x, y) with (0, 0) = infinity."""
    acc = (0, 0, 0)
    if p1 != (0, 0):
        acc = (p1[0], p1[1], 1)
    if p2 != (0, 0):
        acc = _jac_add_affine(acc, p2[0], p2[1])
    return _jac_affinize(acc)


def bn_mul_result(p, s):
    if p == (0, 0):
        return (0, 0)
    acc = (0, 0, 0)
    for i in range(255, -1, -1):
        acc = _jac_double(acc)
        if (s >> i) & 1:
            acc = _jac_add_affine(acc, p[0], p[1])
    return _jac_affinize(acc)


def _z_of(acc):
    return [] if acc[2] == 0 else [pow(acc[2], BN_P - 2, BN_P)]


def bn_add_kernel_hints(p1, p2):
    """PROVER_INPUT words bn_curve.asm pc_bn_add consumes."""
    acc = (0, 0, 0)
    if p1 != (0, 0):
        acc = (p1[0], p1[1], 1)
    if p2 != (0, 0):
        acc = _jac_add_affine(acc, p2[0], p2[1])
    return _z_of(acc)


def bn_mul_kernel_hints(p, s):
    """PROVER_INPUT words bn_curve.asm pc_bn_mul consumes."""
    if p == (0, 0):
        return []
    acc = (0, 0, 0)
    for i in range(255, -1, -1):
        acc = _jac_double(acc)
        if (s >> i) & 1:
            acc = _jac_add_affine(acc, p[0], p[1])
    return _z_of(acc)
