"""The Fibonacci STARK (starky src/fibonacci_stark.rs) through
``plonky2_tpu_torch.stark.prover.prove``.

Inputs: a pool of traces for distinct (x0, x1) drawn from the seed, made
by the benchmark in numpy and handed to the prover as host tensors, as a
user hands them over.  Row i holds (f_i, f_{i+1}, i, i + 1), the last
row's fourth column 0, with f_0 = x0, f_1 = x1: by linearity
f_i = x0 F(i - 1) + x1 F(i) for the Fibonacci numbers F, F(-1) = 1."""

from __future__ import annotations

import numpy as np

from prove_bench.counts import stark as stark_counts
from prove_bench.reference import gl64
from prove_bench.reference import stark as ref

P = gl64.ORDER_INT


def fibonacci_numbers(count: int) -> np.ndarray:
    """F(-1), F(0), ..., F(count - 2) mod p (out[j] = F(j - 1)), by
    doubling: with F known on [-1, K], F(k + K) = F(K - 1) F(k) + F(K) F(k + 1)
    gives F on [K + 1, 2K - 1] in one vectorised step."""
    out = np.array([1, 0, 1, 1, 2], dtype=np.uint64)
    while out.shape[0] < count:
        k = out.shape[0] - 2
        new = gl64.add(gl64.mul(out[2:k + 1], out[k]), gl64.mul(out[3:k + 2], out[k + 1]))
        out = np.concatenate([out, gl64.to_canonical(new)])
    return out[:count]


def fib_trace(x0: int, x1: int, rows: int, fib: np.ndarray | None = None) -> np.ndarray:
    """The (4, rows) trace columns."""
    f = fibonacci_numbers(rows + 2) if fib is None else fib
    # f_i = x0 F(i - 1) + x1 F(i) = x0 f[i] + x1 f[i + 1] for i in [0, rows]
    seq = gl64.to_canonical(gl64.add(gl64.mul(f[:rows + 1], np.uint64(x0 % P)),
                                     gl64.mul(f[1:rows + 2], np.uint64(x1 % P))))
    idx = np.arange(rows, dtype=np.uint64)
    nxt = idx + np.uint64(1)
    nxt[-1] = 0
    return np.stack([seq[:rows], seq[1:rows + 1], idx, nxt])


def program_fri_config(fri: dict):
    """The program's FriConfig for a configuration's "fri" group."""
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    return FriConfig(rate_bits=fri["rate_bits"], cap_height=fri["cap_height"],
                     proof_of_work_bits=fri["proof_of_work_bits"],
                     reduction_strategy=FriReductionStrategy.constant_arity(
                         fri["reduction_arity_bits"], fri["final_poly_bits"]),
                     num_query_rounds=fri["num_query_rounds"])


class Statement:
    def __init__(self, cell, device):
        self.cell = cell
        self.device = device
        self.rows = int(cell.traffic["rows"])

    def program_config(self, config: dict):
        from plonky2_tpu_torch.stark.config import StarkConfig
        return StarkConfig(security_bits=config["security_bits"],
                           num_challenges=config["num_challenges"],
                           fri_config=program_fri_config(config["fri"]),
                           hasher=config["hasher"])

    def setup(self, parts: dict, clock, config: dict | None = None) -> None:
        """config: the configuration the program runs (the cell's, unless a
        control runs another)."""
        from plonky2_tpu_torch.field.goldilocks import GF
        from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
        t = clock()
        self.stark = FibonacciStark(self.rows)
        self.config = self.program_config(config or self.cell.config)
        rng = np.random.default_rng(self.cell.seed)
        pool = int(self.cell.traffic["pool"])
        pairs = set()
        while len(pairs) < pool:
            pairs.add(tuple(int(v) for v in rng.integers(0, P, 2, dtype=np.uint64)))
        self.inputs = sorted(pairs)
        rng.shuffle(self.inputs)
        fib = fibonacci_numbers(self.rows + 2)
        self.traces, self.public = [], []
        for x0, x1 in self.inputs:
            cols = fib_trace(x0, x1, self.rows, fib)
            self.traces.append(GF.from_u64(cols, "cpu"))
            self.public.append(np.array([x0, x1, cols[1, -1]], dtype=np.uint64))
        parts["input_pool_s"] = clock() - t

    def prove(self, i: int, timing):
        from plonky2_tpu_torch.stark.prover import prove
        k = i % len(self.traces)
        return prove(self.stark, self.config, self.traces[k], self.public[k],
                     timing=timing, device=self.device)

    def work(self) -> dict:
        """The proof's shape for the work counts: 4 columns, one
        permutation Z column and one quotient chunk per challenge
        (constraint degree 2)."""
        nc = self.cell.config["num_challenges"]
        return stark_counts.shape(self.rows, 4, nc, nc, 2, self.cell.config["fri"])

    def facts(self, proof) -> dict:
        return {"pow_witness": int(proof.proof.opening_proof.pow_witness)}

    def release(self) -> None:
        self.traces = self.public = None

    # -- judging, with the plain reference ----------------------------------
    def public_ok(self, i: int, proof) -> bool:
        x0, x1 = self.inputs[i % len(self.inputs)]
        want = ref.public_inputs(x0, x1, self.rows)
        got = np.asarray(proof.public_inputs, dtype=np.uint64)
        return got.shape == want.shape and bool((got == want).all())

    def verify(self, proof) -> None:
        """Raises ref.Rejected unless the reference accepts the proof."""
        ref.verify(record(proof), self.cell.config, self.rows)


def _fri_record(fp) -> dict:
    return {"commit_caps": [np.asarray(c.data, dtype=np.uint64)
                            for c in fp.commit_phase_merkle_caps],
            "final_poly": np.asarray(fp.final_poly, dtype=np.uint64),
            "pow_witness": int(fp.pow_witness),
            "queries": [{"initial": [(np.asarray(leaf, dtype=np.uint64),
                                      np.asarray(path.siblings, dtype=np.uint64))
                                     for leaf, path in q.initial_trees_proof.evals_proofs],
                         "steps": [(np.asarray(s.evals, dtype=np.uint64),
                                    np.asarray(s.merkle_proof.siblings, dtype=np.uint64))
                                   for s in q.steps]}
                        for q in fp.query_round_proofs]}


def record(proof) -> dict:
    """The program's proof as the plain record the reference reads."""
    p = proof.proof
    o = p.openings
    perm_cap = p.permutation_zs_cap.data if p.permutation_zs_cap is not None else []
    return {"public_inputs": np.asarray(proof.public_inputs, dtype=np.uint64),
            "trace_cap": np.asarray(p.trace_cap.data, dtype=np.uint64),
            "perm_cap": np.asarray(perm_cap, dtype=np.uint64),
            "quotient_cap": np.asarray(p.quotient_polys_cap.data, dtype=np.uint64),
            "openings": {"local": o.local_values, "next": o.next_values,
                         "perm": o.permutation_zs, "perm_next": o.permutation_zs_next,
                         "quotient": o.quotient_polys},
            "fri": _fri_record(p.opening_proof)}
