"""secp256k1 base and scalar fields (host-side python-int arithmetic).

Twins of reference field/src/secp256k1_base.rs and secp256k1_scalar.rs —
present for ECDSA-gadget ecosystems; not used by the Goldilocks proving path
(same status as in the reference).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PrimeFieldParams:
    order: int
    two_adicity: int
    multiplicative_group_generator: int
    power_of_two_generator: int


SECP256K1_BASE = PrimeFieldParams(
    # p = 2^256 - 2^32 - 977 (secp256k1_base.rs)
    order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    two_adicity=1,
    multiplicative_group_generator=3,
    power_of_two_generator=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2E,
)

SECP256K1_SCALAR = PrimeFieldParams(
    # n = group order (secp256k1_scalar.rs)
    order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    two_adicity=6,
    multiplicative_group_generator=7,
    power_of_two_generator=0x0C1DC060E7A91986DF9879A3FBC483A898BDEAB680756045992F4B5402B052F2,
)


class Fp:
    """A field element modulo params.order (minimal Field-trait surface)."""

    __slots__ = ("v", "params")

    def __init__(self, v: int, params: PrimeFieldParams):
        self.params = params
        self.v = v % params.order

    def _wrap(self, v: int) -> "Fp":
        return Fp(v, self.params)

    def __add__(self, o):
        return self._wrap(self.v + o.v)

    def __sub__(self, o):
        return self._wrap(self.v - o.v)

    def __mul__(self, o):
        return self._wrap(self.v * o.v)

    def __neg__(self):
        return self._wrap(-self.v)

    def inv(self) -> "Fp":
        assert self.v != 0
        return self._wrap(pow(self.v, self.params.order - 2, self.params.order))

    def pow(self, e: int) -> "Fp":
        return self._wrap(pow(self.v, e, self.params.order))

    def __eq__(self, o):
        return isinstance(o, Fp) and self.v == o.v and self.params is o.params

    def __repr__(self):
        return f"Fp({self.v:#x})"


def base(v: int) -> Fp:
    return Fp(v, SECP256K1_BASE)


def scalar(v: int) -> Fp:
    return Fp(v, SECP256K1_SCALAR)


def primitive_root_of_unity(params: PrimeFieldParams, n_log: int) -> int:
    assert 0 <= n_log <= params.two_adicity
    g = params.power_of_two_generator
    for _ in range(params.two_adicity - n_log):
        g = (g * g) % params.order
    return g


# ---------------------------------------------------------------- curve ops
# Twin of reference plonky2/evm curve usage (evm/src/cpu/kernel/asm/curve/
# secp256k1/{curve_add.asm, glv.asm, ecrecover.asm} semantics): affine
# python-int arithmetic — the host oracle behind the kernel's
# nondeterministic hints and the trusted twin the in-kernel ecrecover is
# tested against.

_P = SECP256K1_BASE.order
_N = SECP256K1_SCALAR.order
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def ec_add(p1, p2):
    """Affine point add on y^2 = x^3 + 7 (None = infinity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % _P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, _P - 2, _P) % _P
    else:
        lam = (y2 - y1) * pow(x2 - x1, _P - 2, _P) % _P
    x3 = (lam * lam - x1 - x2) % _P
    y3 = (lam * (x1 - x3) - y1) % _P
    return (x3, y3)


def ec_double(p):
    return ec_add(p, p)


def ec_mul(p, k: int):
    """Double-and-add scalar multiplication."""
    acc = None
    add = p
    while k:
        if k & 1:
            acc = ec_add(acc, add)
        add = ec_add(add, add)
        k >>= 1
    return acc


def is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 7) % _P == 0


def ecdsa_recover(msg_hash: int, v: int, r: int, s: int):
    """Public key recovery (EIP-2-style strictness left to callers;
    reference ecrecover.asm).  Returns (x, y) or None if invalid."""
    if not (1 <= r < _N and 1 <= s < _N and v in (27, 28)):
        return None
    x = r  # the r + n lift is valid but vanishingly rare; reject like geth's
    if x >= _P:
        return None
    y_sq = (pow(x, 3, _P) + 7) % _P
    y = pow(y_sq, (_P + 1) // 4, _P)
    if (y * y) % _P != y_sq:
        return None  # r not an x-coordinate on the curve
    if (y & 1) != (v - 27):
        y = _P - y
    r_inv = pow(r, _N - 2, _N)
    u1 = (-msg_hash * r_inv) % _N
    u2 = (s * r_inv) % _N
    q = ec_add(ec_mul((GX, GY), u1), ec_mul((x, y), u2))
    if q is None:
        return None
    return q


def ecdsa_sign(msg_hash: int, priv: int, k: int):
    """Deterministic-k test signer. Returns (v, r, s)."""
    R = ec_mul((GX, GY), k)
    r = R[0] % _N
    assert r != 0
    s = (pow(k, _N - 2, _N) * (msg_hash + r * priv)) % _N
    assert s != 0
    v = 27 + (R[1] & 1)
    # note: if r >= p - n (never for random k) the recovery x-lift differs
    return v, r, s


def pubkey_to_address(q) -> bytes:
    """keccak256(uncompressed pubkey)[12:] (transactions/type_0.asm flow)."""
    from ..hash.keccak import keccak256
    buf = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return keccak256(buf)[12:]


# ------------------------------------------------- in-kernel ecrecover twin
# The kernel (zkevm/kernel/asm/curve.asm) runs the ladder in Jacobian
# coordinates so the only field inversions are nondeterministic hints
# checked with one MULMOD each.  These host twins replicate the kernel's
# exact formulas and branch structure; ecrecover_kernel_hints produces the
# PROVER_INPUT stream [y, r_inv mod n, z_inv mod p] the kernel consumes.

def _jac_double(pt):
    x1, y1, z1 = pt
    a = x1 * x1 % _P
    b = y1 * y1 % _P
    c = b * b % _P
    d = 2 * ((x1 + b) * (x1 + b) % _P - a - c) % _P
    e = 3 * a % _P
    f = e * e % _P
    x3 = (f - 2 * d) % _P
    y3 = (e * (d - x3) - 8 * c) % _P
    z3 = 2 * y1 * z1 % _P
    return (x3, y3, z3)


def _jac_add_mixed(pt, x2, y2):
    x1, y1, z1 = pt
    if z1 == 0:
        return (x2, y2, 1)
    z1z1 = z1 * z1 % _P
    u2 = x2 * z1z1 % _P
    s2 = y2 * z1 % _P * z1z1 % _P
    h = (u2 - x1) % _P
    rr = 2 * (s2 - y1) % _P
    if h == 0:
        if rr == 0:
            return _jac_double(pt)
        return (x1, y1, 0)  # opposite points: kernel only zeroes AZ
    hh = h * h % _P
    i = 4 * hh % _P
    j = h * i % _P
    v = x1 * i % _P
    x3 = (rr * rr - j - 2 * v) % _P
    y3 = (rr * (v - x3) - 2 * y1 * j) % _P
    z3 = 2 * z1 * h % _P
    return (x3, y3, z3)


def _kernel_ladder(u1: int, u2: int, qx: int, qy: int):
    """The kernel's Shamir double-and-add, acc in Jacobian coords."""
    acc = (0, 0, 0)
    for i in range(255, -1, -1):
        acc = _jac_double(acc)
        if (u1 >> i) & 1:
            acc = _jac_add_mixed(acc, GX, GY)
        if (u2 >> i) & 1:
            acc = _jac_add_mixed(acc, qx, qy)
    return acc


def ecrecover_kernel_hints(msg_hash: int, v: int, r: int, s: int) -> list:
    """PROVER_INPUT words for curve.asm ecrecover: [y, r_inv, z_inv].
    Raises if the signature is invalid (the kernel would PANIC — such a
    block is unprovable, matching the reference's semantics)."""
    assert 1 <= r < _N and 1 <= s < _N and v in (27, 28), "invalid signature"
    y_sq = (pow(r, 3, _P) + 7) % _P
    y = pow(y_sq, (_P + 1) // 4, _P)
    assert y * y % _P == y_sq, "r is not a curve x-coordinate"
    if (y & 1) != (v - 27):
        y = _P - y
    r_inv = pow(r, _N - 2, _N)
    u1 = (_N - msg_hash % _N) * r_inv % _N
    u2 = s * r_inv % _N
    acc = _kernel_ladder(u1, u2, r, y)
    assert acc[2] != 0, "signature recovers the point at infinity"
    z_inv = pow(acc[2], _P - 2, _P)
    return [y, r_inv, z_inv]


def ecrecover_kernel_twin(msg_hash: int, v: int, r: int, s: int) -> bytes:
    """The address the kernel ladder recovers (must equal
    pubkey_to_address(ecdsa_recover(...)) — pinned by tests)."""
    hints = ecrecover_kernel_hints(msg_hash, v, r, s)
    y, r_inv, z_inv = hints
    u1 = (_N - msg_hash % _N) * r_inv % _N
    u2 = s * r_inv % _N
    X, Y, Z = _kernel_ladder(u1, u2, r, y)
    zi2 = z_inv * z_inv % _P
    x_aff = X * zi2 % _P
    y_aff = Y * zi2 % _P * z_inv % _P
    return pubkey_to_address((x_aff, y_aff))
