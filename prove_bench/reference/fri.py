"""FRI verification in plain numpy (reference plonky2 fri/verifier.rs,
fri/challenges.rs, fri/validate_shape.rs), over a proof given as a plain
record of numpy arrays:

    {"commit_caps": [(2^h, 4)], "final_poly": (k, 2), "pow_witness": int,
     "queries": [{"initial": [(leaf (L,), siblings (d, 4))] per oracle,
                  "steps": [(evals (arity, 2), siblings (d, 4))]}]}

An instance is a list of oracles (their polynomial counts) and of opening
batches: an extension point, the (oracle, polynomial) pairs opened there,
and their claimed values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import gl64, gl64ext
from .hashing import Challenger, verify_merkle_paths


class Rejected(Exception):
    """The proof does not verify."""


def ensure(cond: bool, msg: str) -> None:
    if not cond:
        raise Rejected(msg)


@dataclass(frozen=True)
class FriParams:
    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    num_query_rounds: int
    degree_bits: int
    reduction_arity_bits: tuple

    @staticmethod
    def from_config(fri: dict, degree_bits: int) -> "FriParams":
        """A configuration's "fri" group: rate_bits, cap_height,
        proof_of_work_bits, num_query_rounds and the constant-arity
        reduction (reduction_arity_bits, final_poly_bits), folded while
        the degree is above the final polynomial's and the folded tree
        stays above the cap (fri/reduction_strategies.rs)."""
        arity, final_bits = fri["reduction_arity_bits"], fri["final_poly_bits"]
        arities, d = [], degree_bits
        while d > final_bits and d + fri["rate_bits"] - arity >= fri["cap_height"]:
            arities.append(arity)
            d -= arity
        return FriParams(fri["rate_bits"], fri["cap_height"],
                         fri["proof_of_work_bits"], fri["num_query_rounds"],
                         degree_bits, tuple(arities))

    def lde_bits(self) -> int:
        return self.degree_bits + self.rate_bits

    def final_poly_len(self) -> int:
        return 1 << (self.degree_bits - sum(self.reduction_arity_bits))


@dataclass
class Batch:
    point: np.ndarray      # (2,)
    polys: list            # of (oracle index, polynomial index)
    values: np.ndarray     # (len(polys), 2)


def reverse_bits(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def observe_openings(challenger: Challenger, batches: list) -> None:
    for b in batches:
        challenger.observe_elements(np.asarray(b.values, dtype=np.uint64))


def challenges(challenger: Challenger, proof: dict, params: FriParams) -> dict:
    """alpha, the fold betas, the PoW response and the query indices, after
    the openings were observed."""
    alpha = challenger.get_extension_challenge()
    betas = []
    for cap in proof["commit_caps"]:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    challenger.observe_elements(np.asarray(proof["final_poly"], dtype=np.uint64))
    challenger.observe_element(proof["pow_witness"])
    pow_response = challenger.get_challenge()
    n = 1 << params.lde_bits()
    indices = [challenger.get_challenge() % n for _ in range(params.num_query_rounds)]
    return {"alpha": alpha, "betas": betas, "pow_response": pow_response,
            "indices": indices}


def _check_shape(proof: dict, oracle_sizes: list, params: FriParams) -> None:
    h = params.cap_height
    ensure(len(proof["commit_caps"]) == len(params.reduction_arity_bits),
           "wrong number of commit-phase caps")
    for cap in proof["commit_caps"]:
        ensure(np.shape(cap) == (1 << h, 4), "commit-phase cap has the wrong size")
    ensure(len(proof["queries"]) == params.num_query_rounds,
           "wrong number of query rounds")
    for q in proof["queries"]:
        ensure(len(q["initial"]) == len(oracle_sizes),
               "initial openings do not match the oracles")
        for (leaf, sibs), size in zip(q["initial"], oracle_sizes):
            ensure(np.shape(leaf) == (size,), "initial leaf has the wrong length")
            ensure(np.shape(sibs) == (params.lde_bits() - h, 4),
                   "initial Merkle path has the wrong depth")
        ensure(len(q["steps"]) == len(params.reduction_arity_bits),
               "wrong number of query steps")
        bits = params.lde_bits()
        for (evals, sibs), arity_bits in zip(q["steps"], params.reduction_arity_bits):
            bits -= arity_bits
            ensure(np.shape(evals) == (1 << arity_bits, 2),
                   "query step evals do not match the arity")
            ensure(np.shape(sibs) == (bits - h, 4),
                   "query step Merkle path has the wrong depth")
    ensure(np.shape(proof["final_poly"]) == (params.final_poly_len(), 2),
           "final polynomial has the wrong length")


def _reduce(values: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """sum_j alpha^j values[j], for base (k,) or extension (k, 2) values."""
    values = np.asarray(values, dtype=np.uint64)
    powers = gl64ext.powers(alpha, values.shape[0])
    if values.ndim == 1:
        return gl64ext.total(gl64ext.scalar_mul(powers, values))
    return gl64ext.total(gl64ext.mul(values, powers))


def _sum_rows(x: np.ndarray) -> np.ndarray:
    """Sum of (Q, k, 2) extension elements over k, by pairwise halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = np.concatenate([x, np.zeros_like(x[:, :1])], axis=1)
        x = gl64ext.add(x[:, 0::2], x[:, 1::2])
    return x[:, 0]


def _reduce_rows(values: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """sum_j alpha^j values[:, j] for base values (Q, k)."""
    powers = gl64ext.powers(alpha, values.shape[1])
    return _sum_rows(gl64ext.scalar_mul(powers[None], values))


def _fold(xs: np.ndarray, evals: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Each query's folded value: the polynomial through its coset's
    points xs (Q, A) and values evals (Q, A, 2), at beta, by Lagrange's
    formula."""
    q, a = xs.shape
    diffs = gl64.sub(xs[:, :, None], xs[:, None, :])
    diffs[:, np.arange(a), np.arange(a)] = 1
    denom = np.ones((q, a), dtype=np.uint64)
    for j in range(a):
        denom = gl64.mul(denom, diffs[:, :, j])
    weights = gl64.batch_inv(denom)
    d = gl64ext.sub(np.broadcast_to(beta, (q, a, 2)), gl64ext.from_base(xs))
    ensure(not gl64ext.is_zero(d).any(), "a fold's challenge lies on its coset")
    l_x = np.broadcast_to(gl64ext.ONE, (q, 2)).copy()
    for i in range(a):
        l_x = gl64ext.mul(l_x, d[:, i])
    terms = gl64ext.mul(gl64ext.scalar_mul(gl64ext.inv(d), weights), evals)
    return gl64ext.mul(l_x, _sum_rows(terms))


def verify(instance_sizes: list, batches: list, caps: list, proof: dict,
           chal: dict, params: FriParams) -> None:
    """Raises Rejected unless the FRI proof opens the claimed batches."""
    _check_shape(proof, instance_sizes, params)
    ensure(chal["pow_response"] < (1 << (64 - params.proof_of_work_bits)),
           "the proof-of-work witness is too weak")
    queries = proof["queries"]
    idx = np.asarray(chal["indices"], dtype=np.int64)
    for t, cap in enumerate(caps):
        ensure(verify_merkle_paths(
            np.stack([q["initial"][t][0] for q in queries]), idx, cap,
            np.stack([q["initial"][t][1] for q in queries])),
            f"initial Merkle path {t} does not reach its cap")
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        idx = idx >> arity_bits
        ensure(verify_merkle_paths(
            np.stack([np.asarray(q["steps"][i][0]).reshape(-1) for q in queries]),
            idx, proof["commit_caps"][i],
            np.stack([q["steps"][i][1] for q in queries])),
            f"commit-phase Merkle path {i} does not reach its cap")

    alpha = chal["alpha"]
    p = gl64.ORDER_INT
    log_n = params.lde_bits()
    g_n = gl64.primitive_root_of_unity(log_n)
    index = np.asarray(chal["indices"], dtype=np.int64)
    x = np.array([gl64.MULTIPLICATIVE_GROUP_GENERATOR
                  * pow(g_n, reverse_bits(int(i), log_n), p) % p for i in index],
                 dtype=np.uint64)
    # sum over batches of alpha^(polys after) (F(x) - F(z)) / (x - z)
    acc = np.zeros((len(queries), 2), dtype=np.uint64)
    for b in batches:
        evals = np.array([[q["initial"][o][0][j] for o, j in b.polys]
                          for q in queries], dtype=np.uint64)
        num = gl64ext.sub(_reduce_rows(evals, alpha),
                          _reduce(b.values, alpha)[None])
        den = gl64ext.sub(gl64ext.from_base(x), b.point[None])
        acc = gl64ext.mul(acc, gl64ext.pow_int(alpha, len(b.polys))[None])
        acc = gl64ext.add(acc, gl64ext.mul(num, gl64ext.inv(den)))
    rows = np.arange(len(queries))
    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = np.stack([np.asarray(q["steps"][i][0], dtype=np.uint64)
                          for q in queries])
        within = index & (arity - 1)
        ensure(bool(gl64ext.equal(evals[rows, within], acc).all()),
               f"fold {i} is inconsistent with the round before")
        g = gl64.primitive_root_of_unity(arity_bits)
        perm = [reverse_bits(j, arity_bits) for j in range(arity)]
        start = np.array([int(xi) * pow(g, arity - reverse_bits(int(w), arity_bits), p) % p
                          for xi, w in zip(x, within)], dtype=np.uint64)
        coset = gl64.mul(start[:, None], gl64.powers(g, arity)[None])
        acc = _fold(coset, evals[:, perm], chal["betas"][i])
        x = np.array([pow(int(xi), arity, p) for xi in x], dtype=np.uint64)
        index = index >> arity_bits
    final = np.zeros((len(queries), 2), dtype=np.uint64)
    xe = gl64ext.from_base(x)
    for c in np.asarray(proof["final_poly"], dtype=np.uint64)[::-1]:
        final = gl64ext.add(gl64ext.mul(final, xe), c[None])
    ensure(bool(gl64ext.equal(final, acc).all()),
           "the final polynomial disagrees with the last fold")
