"""The work counts against the permutations and transforms a small prove
on the CPU makes, found by wrapping the program's plain CPU paths."""

import json
from pathlib import Path

import numpy as np
import pytest

from prove_bench.counts import peaks, stark
from prove_bench.statements import fib as fib_statement

CONFIG = json.loads((Path(fib_statement.__file__).parents[1] / "configs"
                     / "fib_stark_fast.json").read_text())


def test_poseidon_muls_fast_schedule():
    assert peaks.poseidon_muls() == 6272


@pytest.fixture(scope="module")
def observed():
    """Calls of the program's plain permutation, sponge and transforms
    during one 2^10-row prove under the cell's configuration."""
    from plonky2_tpu_torch.field import ntt
    from plonky2_tpu_torch.hash import hashing, poseidon
    calls = []
    saved = {}

    def wrap(mod, name):
        fn = saved[(mod, name)] = getattr(mod, name)

        def counted(x, *args, **kwargs):
            calls.append((name, tuple(getattr(x, "shape", ())), args))
            return fn(x, *args, **kwargs)
        setattr(mod, name, counted)

    for name in ("ntt_torch", "intt_torch", "coset_ntt_torch", "coset_intt_torch",
                 "lde_torch"):
        wrap(ntt, name)
    wrap(poseidon, "permute_torch")
    wrap(hashing, "hash_no_pad_torch")
    try:
        from plonky2_tpu_torch.field.goldilocks import GF
        from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
        from plonky2_tpu_torch.stark.prover import prove
        st = fib_statement.Statement.__new__(fib_statement.Statement)
        cfg = st.program_config(CONFIG)
        rows = 1 << 10
        trace = fib_statement.fib_trace(3, 4, rows)
        proof = prove(FibonacciStark(rows), cfg, GF.from_u64(trace, "cpu"),
                      np.array([3, 4, trace[1, -1]], np.uint64), device="cpu")
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return calls, int(proof.proof.opening_proof.pow_witness)


def test_permutations_match_a_small_prove(observed):
    calls, witness = observed
    s = stark.shape(1 << 10, 4, 2, 2, 2, CONFIG["fri"])
    pow_batch = 1 << 16
    trees = sum(shape[0] for name, shape, _ in calls
                if name == "permute_torch" and shape[0] != pow_batch)
    trees += sum(shape[0] * -(-shape[1] // 8) for name, shape, _ in calls
                 if name == "hash_no_pad_torch")
    grind = sum(shape[0] for name, shape, _ in calls
                if name == "permute_torch" and shape[0] == pow_batch)
    assert stark.permutations(s) == trees
    assert stark.grind_permutations(witness) <= grind


def test_ntt_bytes_are_a_floor_of_a_small_prove(observed):
    calls, _ = observed
    s = stark.shape(1 << 10, 4, 2, 2, 2, CONFIG["fri"])
    done = 0
    for name, shape, args in calls:
        polys = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        n = shape[-1]
        if name == "lde_torch":
            done += 8 * polys * (n + (n << args[0]))
        elif name in ("ntt_torch", "intt_torch"):
            done += 8 * 2 * polys * n
    # the coset transforms call the plain ones: counted there
    need = stark.ntt_bytes(s)
    assert 0 < need <= done
    # the trace, Z and quotient transforms and the FRI LDE are all needed
    n, big = 1 << 10, 1 << 11
    assert need >= 8 * (2 * 4 * n + 4 * (n + big) + 2 * 2 * n + 2 * (n + big)
                        + 2 * 2 * n + 2 * (n + big) + 2 * (n + big))


def test_counts_grow_with_the_rows():
    small = stark.shape(1 << 20, 4, 2, 2, 2, CONFIG["fri"])
    big = stark.shape(1 << 22, 4, 2, 2, 2, CONFIG["fri"])
    assert 3.9 < stark.permutations(big) / stark.permutations(small) < 4.1
    assert 3.9 < stark.ntt_bytes(big) / stark.ntt_bytes(small) < 4.1
