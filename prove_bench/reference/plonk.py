"""PLONK verification in plain numpy (reference plonky2 plonk/verifier.rs,
plonk/get_challenges.rs, plonk/vanishing_poly.rs, the gates' constraint
evaluation), for circuits built from the gates below, without zero
knowledge or lookups; and the matrix-multiplication statement's public
values.

A circuit is described by a plain record, judged against the one pinned
in the cell's workload file (the verifying key):

    {"gates": [gate ids], "selector_indices": [...], "selector_groups":
     [[start, stop]], "num_constants": k, "num_public_inputs": m,
     "degree_bits": d, "constants_sigmas_cap": (2^h, 4), "circuit_digest": (4,)}

A proof comes as a plain record:

    {"public_inputs": (m,), "wires_cap", "zs_cap", "quotient_cap": (2^h, 4),
     "openings": {"constants", "plonk_sigmas", "wires", "plonk_zs",
     "plonk_zs_next", "partial_products", "quotient_polys": (k, 2)},
     "fri": a FRI record (fri.py)}
"""

from __future__ import annotations

import re

import numpy as np

from . import gl64
from . import poseidon_constants as C
from .fri import Batch, FriParams, Rejected, challenges, ensure, observe_openings
from .fri import verify as verify_fri
from .gl64ext import E2
from .hashing import Challenger, hash_no_pad

P = gl64.ORDER_INT
UNUSED_SELECTOR = (1 << 32) - 1
WIDTH = C.SPONGE_WIDTH


def matmul_public_inputs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[a_ij, b_ij, c_ij for each (i, j)] with C = A B mod p."""
    a = np.asarray(a, dtype=object) % P
    b = np.asarray(b, dtype=object) % P
    c = a.dot(b) % P
    return np.stack([a, b, c], axis=-1).reshape(-1).astype(np.uint64)


# -- gates: constraint evaluation at one point (reference plonk/gates) -------

class ArithmeticGate:
    """num_ops slots of output = c0 m0 m1 + c1 addend."""

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def eval(self, consts: list, w: list, pi_hash: list) -> list:
        c0, c1 = consts[0], consts[1]
        return [w[4 * i + 3] - (w[4 * i] * w[4 * i + 1] * c0 + w[4 * i + 2] * c1)
                for i in range(self.num_ops)]


class ConstantGate:
    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def eval(self, consts, w, pi_hash):
        return [consts[i] - w[i] for i in range(self.num_consts)]


class PublicInputGate:
    def eval(self, consts, w, pi_hash):
        return [w[i] - pi_hash[i] for i in range(4)]


class NoopGate:
    def eval(self, consts, w, pi_hash):
        return []


class PoseidonGate:
    """One permutation a row, checked round by round on the wires that
    hold each S-box's input (reference gates/poseidon.rs).  Wires: inputs
    0..12, outputs 12..24, swap 24, deltas 25..29, the S-box inputs of full
    rounds 1..3, of the 22 partial rounds, and of the last 4 full rounds.
    The partial rounds follow the fast schedule (hash/poseidon.rs), which
    the gate's wires record."""

    SWAP = 2 * WIDTH
    DELTA = SWAP + 1
    FULL_0 = DELTA + 4
    PARTIAL = FULL_0 + WIDTH * (C.HALF_N_FULL_ROUNDS - 1)
    FULL_1 = PARTIAL + C.N_PARTIAL_ROUNDS

    @staticmethod
    def _sbox(x):
        x2 = x * x
        return x * x2 * (x2 * x2)

    @staticmethod
    def _c(v: int) -> E2:
        return E2.of(v % P)

    def _full_round(self, state, rc):
        return [s + self._c(C.ALL_ROUND_CONSTANTS[i + WIDTH * rc])
                for i, s in enumerate(state)]

    def _mds(self, state):
        out = []
        for r in range(WIDTH):
            acc = state[r] * self._c(C.MDS_MATRIX_DIAG[r])
            for i in range(WIDTH):
                acc = acc + state[(i + r) % WIDTH] * self._c(C.MDS_MATRIX_CIRC[i])
            out.append(acc)
        return out

    def _partial_fast(self, state, r):
        d = state[0] * self._c(C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0])
        for i in range(1, WIDTH):
            d = d + state[i] * self._c(C.FAST_PARTIAL_ROUND_W_HATS[r][i - 1])
        return [d] + [state[0] * self._c(C.FAST_PARTIAL_ROUND_VS[r][i - 1]) + state[i]
                      for i in range(1, WIDTH)]

    def eval(self, consts, w, pi_hash):
        one = E2.of(1)
        half = C.HALF_N_FULL_ROUNDS
        swap = w[self.SWAP]
        out = [swap * (swap - one)]
        for i in range(4):
            out.append(swap * (w[i + 4] - w[i]) - w[self.DELTA + i])
        state = list(w[:WIDTH])
        for i in range(4):
            state[i] = w[i] + w[self.DELTA + i]
            state[i + 4] = w[i + 4] - w[self.DELTA + i]
        rc = 0
        for r in range(half):
            state = self._full_round(state, rc)
            if r:
                for i in range(WIDTH):
                    sbox_in = w[self.FULL_0 + WIDTH * (r - 1) + i]
                    out.append(state[i] - sbox_in)
                    state[i] = sbox_in
            state = self._mds([self._sbox(s) for s in state])
            rc += 1
        state = [s + self._c(c) for s, c in zip(state, C.FAST_PARTIAL_FIRST_ROUND_CONSTANT)]
        init = [state[0]] + [None] * (WIDTH - 1)
        for r in range(1, WIDTH):
            for c in range(1, WIDTH):
                t = state[r] * self._c(C.FAST_PARTIAL_ROUND_INITIAL_MATRIX[r - 1][c - 1])
                init[c] = t if init[c] is None else init[c] + t
        state = init
        for r in range(C.N_PARTIAL_ROUNDS):
            sbox_in = w[self.PARTIAL + r]
            out.append(state[0] - sbox_in)
            state[0] = self._sbox(sbox_in)
            if r < C.N_PARTIAL_ROUNDS - 1:
                state[0] = state[0] + self._c(C.FAST_PARTIAL_ROUND_CONSTANTS[r])
            state = self._partial_fast(state, r)
        rc += C.N_PARTIAL_ROUNDS
        for r in range(half):
            state = self._full_round(state, rc)
            for i in range(WIDTH):
                sbox_in = w[self.FULL_1 + WIDTH * r + i]
                out.append(state[i] - sbox_in)
                state[i] = sbox_in
            state = self._mds([self._sbox(s) for s in state])
            rc += 1
        out += [state[i] - w[WIDTH + i] for i in range(WIDTH)]
        return out


def gate_from_id(gate_id: str):
    m = re.fullmatch(r"ArithmeticGate \{ num_ops: (\d+) \}", gate_id)
    if m:
        return ArithmeticGate(int(m.group(1)))
    m = re.fullmatch(r"ConstantGate \{ num_consts: (\d+) \}", gate_id)
    if m:
        return ConstantGate(int(m.group(1)))
    if gate_id == "PublicInputGate":
        return PublicInputGate()
    if gate_id == "NoopGate":
        return NoopGate()
    if gate_id.startswith("PoseidonGate(") and gate_id.endswith("<WIDTH=12>"):
        return PoseidonGate()
    raise Rejected(f"the reference has no gate {gate_id!r}")


# -- the verifier -------------------------------------------------------------

def circuit_digest(cap: np.ndarray, degree_bits: int) -> np.ndarray:
    """H(cap || H_pad("") || degree_bits) (reference circuit_builder.rs)."""
    pad_empty = np.zeros(WIDTH, dtype=np.uint64)
    pad_empty[0] = pad_empty[-1] = 1
    return hash_no_pad(np.concatenate([
        np.asarray(cap, dtype=np.uint64).reshape(-1), hash_no_pad(pad_empty),
        np.array([degree_bits], dtype=np.uint64)]))


def check_circuit(circuit: dict, pinned: dict) -> None:
    """The program's circuit description against the pinned verifying key,
    and the digest against the committed constants and sigmas."""
    for key, want in pinned.items():
        got = circuit[key]
        if key == "circuit_digest":
            got = [int(v) for v in got]
        ensure(got == want, f"the circuit's {key} differs from the pinned one")
    digest = circuit_digest(circuit["constants_sigmas_cap"], circuit["degree_bits"])
    ensure([int(v) for v in digest] == [int(v) for v in circuit["circuit_digest"]],
           "the circuit digest does not commit to the constants and sigmas")


def verify(proof: dict, circuit: dict, config: dict) -> None:
    """Raises Rejected unless the proof verifies against the circuit under
    the configuration's parameters."""
    ensure(not config["zero_knowledge"], "the reference verifies no zk proofs")
    degree_bits = circuit["degree_bits"]
    params = FriParams.from_config(config["fri"], degree_bits)
    nc = config["num_challenges"]
    qdf = config["max_quotient_degree_factor"]
    routed = config["num_routed_wires"]
    num_wires = config["num_wires"]
    num_prods = -(-routed // qdf) - 1
    num_consts = circuit["num_constants"]
    h = params.cap_height
    o = proof["openings"]
    for name in ("wires_cap", "zs_cap", "quotient_cap"):
        ensure(np.shape(proof[name]) == (1 << h, 4), f"{name} has the wrong size")
    for name, k in (("constants", num_consts), ("plonk_sigmas", routed),
                    ("wires", num_wires), ("plonk_zs", nc), ("plonk_zs_next", nc),
                    ("partial_products", nc * num_prods),
                    ("quotient_polys", nc * qdf)):
        ensure(np.shape(o[name]) == (k, 2), f"wrong number of {name} openings")
    pis = np.asarray(proof["public_inputs"], dtype=np.uint64)
    ensure(pis.shape == (circuit["num_public_inputs"],),
           "wrong number of public inputs")
    pi_hash = hash_no_pad(gl64.to_canonical(pis))

    ch = Challenger()
    ch.observe_elements(np.asarray(circuit["circuit_digest"], dtype=np.uint64))
    ch.observe_elements(pi_hash)
    ch.observe_cap(proof["wires_cap"])
    betas = ch.get_n_challenges(nc)
    gammas = ch.get_n_challenges(nc)
    ch.observe_cap(proof["zs_cap"])
    alphas = ch.get_n_challenges(nc)
    ch.observe_cap(proof["quotient_cap"])
    zeta = ch.get_extension_challenge()
    g = gl64.primitive_root_of_unity(degree_bits)
    preprocessed = num_consts + routed
    zs_pp = nc * (1 + num_prods)
    batches = [
        Batch(zeta, [(0, i) for i in range(preprocessed)]
              + [(1, i) for i in range(num_wires)]
              + [(2, i) for i in range(zs_pp)] + [(3, i) for i in range(nc * qdf)],
              np.concatenate([o["constants"], o["plonk_sigmas"], o["wires"],
                              o["plonk_zs"], o["partial_products"],
                              o["quotient_polys"]])),
        Batch(gl64.mul(zeta, np.uint64(g)), [(2, i) for i in range(nc)],
              np.asarray(o["plonk_zs_next"])),
    ]
    observe_openings(ch, batches)
    chal = challenges(ch, proof["fri"], params)

    z = E2(zeta)
    one = E2.of(1)
    n = 1 << degree_bits
    zeta_n = z.pow_const(n)
    z_h = zeta_n - one
    l_0 = z_h * ((z - one) * E2.of(n)).inv()
    consts = [E2(v) for v in o["constants"]]
    wires = [E2(v) for v in o["wires"]]
    sigmas = [E2(v) for v in o["plonk_sigmas"]]
    zs = [E2(v) for v in o["plonk_zs"]]
    zs_next = [E2(v) for v in o["plonk_zs_next"]]
    partials = [E2(v) for v in o["partial_products"]]
    pi_e = [E2.of(int(v)) for v in pi_hash]

    terms = [l_0 * (zs[i] - one) for i in range(nc)]
    for i in range(nc):
        beta, gamma = E2.of(betas[i]), E2.of(gammas[i])
        nums = [wires[j] + z * (beta * E2.of(pow(gl64.MULTIPLICATIVE_GROUP_GENERATOR, j, P)))
                + gamma for j in range(routed)]
        dens = [wires[j] + sigmas[j] * beta + gamma for j in range(routed)]
        accs = [zs[i]] + partials[i * num_prods:(i + 1) * num_prods] + [zs_next[i]]
        for ci, start in enumerate(range(0, routed, qdf)):
            num_p, den_p = one, one
            for t in nums[start:start + qdf]:
                num_p = num_p * t
            for t in dens[start:start + qdf]:
                den_p = den_p * t
            terms.append(accs[ci] * num_p - accs[ci + 1] * den_p)

    groups = [range(a, b) for a, b in circuit["selector_groups"]]
    num_selectors = len(groups)
    gate_terms = []
    for gi, gate_id in enumerate(circuit["gates"]):
        gate = gate_from_id(gate_id)
        sel = circuit["selector_indices"][gi]
        s = consts[sel]
        filt = one
        for k in [k for k in groups[sel] if k != gi] + (
                [UNUSED_SELECTOR] if num_selectors > 1 else []):
            filt = filt * (E2.of(k) - s)
        for j, c in enumerate(gate.eval(consts[num_selectors:], wires, pi_e)):
            fc = filt * c
            if j < len(gate_terms):
                gate_terms[j] = gate_terms[j] + fc
            else:
                gate_terms.append(fc)
    terms += gate_terms

    for i, alpha in enumerate(alphas):
        a = E2.of(alpha)
        acc = E2.of(0)
        for t in reversed(terms):
            acc = acc * a + t
        quotient = E2.of(0)
        for c in o["quotient_polys"][i * qdf:(i + 1) * qdf][::-1]:
            quotient = quotient * zeta_n + E2(c)
        ensure(acc.equals(z_h * quotient),
               f"the vanishing polynomial fails at zeta (challenge {i})")
    verify_fri([preprocessed, num_wires, zs_pp, nc * qdf], batches,
               [circuit["constants_sigmas_cap"], proof["wires_cap"],
                proof["zs_cap"], proof["quotient_cap"]],
               proof["fri"], chal, params)
