"""The plain reference: public values, the permutation, and the verifiers
on proofs the program makes on the CPU (accepted) and on altered ones
(rejected)."""

import numpy as np
import pytest

from prove_bench.reference import hashing, plonk, stark
from prove_bench.statements import fib as fib_statement
from prove_bench.statements import matmul as matmul_statement
from prove_bench.tests.fixtures import MATMUL_2_KEY, tiny

P = 0xFFFFFFFF00000001


def test_fib_result_matches_the_program():
    from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
    for rows in (2, 3, 64, 1000):
        for x0, x1 in ((0, 1), (5, 7), (P - 3, 2**62)):
            assert stark.fib_result(x0, x1, rows) == FibonacciStark(rows).expected_result(x0, x1)


def test_matmul_public_inputs_match_the_program():
    from plonky2_tpu_torch.models.matrix_mul import expected_product
    rng = np.random.default_rng(5)
    a = rng.integers(0, P, (4, 4), dtype=np.uint64)
    b = rng.integers(0, P, (4, 4), dtype=np.uint64)
    pis = plonk.matmul_public_inputs(a, b).reshape(4, 4, 3)
    assert (pis[..., 0] == a).all() and (pis[..., 1] == b).all()
    assert (pis[..., 2] == expected_product(a, b)).all()


def test_permutation_matches_the_program():
    from plonky2_tpu_torch.hash.poseidon import permute_np
    rng = np.random.default_rng(3)
    states = rng.integers(0, 2**64, (20, 12), dtype=np.uint64)
    want = permute_np(states) % np.uint64(P)
    assert (hashing.permute(states) == want).all()
    assert all((hashing.permute(states[i]) == want[i]).all() for i in range(20))


class _Cell:
    def __init__(self, config, traffic, key=None):
        self.config, self.traffic, self.seed, self.key = config, traffic, 77, key
        self.name = "t"

    def pinned_key(self):
        return self.key


@pytest.fixture(scope="module")
def stark_proof():
    import json
    from pathlib import Path
    config = tiny(json.loads((Path(fib_statement.__file__).parents[1] / "configs"
                              / "fib_stark_fast.json").read_text()), 8, 2)
    st = fib_statement.Statement(_Cell(config, {"rows": 256, "pool": 2}), "cpu")
    st.setup({}, lambda: 0.0)
    return st, st.prove(0, None)


def test_stark_reference_accepts_and_rejects(stark_proof):
    st, proof = stark_proof
    assert st.public_ok(0, proof)
    assert not st.public_ok(1, proof)
    st.verify(proof)
    rec = fib_statement.record(proof)
    rec["openings"]["quotient"] = rec["openings"]["quotient"].copy()
    rec["openings"]["quotient"][0, 1] ^= np.uint64(1)
    with pytest.raises(stark.Rejected):
        stark.verify(rec, st.cell.config, st.rows)
    rec = fib_statement.record(proof)
    rec["fri"]["queries"][3]["initial"][0][0][2] ^= np.uint64(4)
    with pytest.raises(stark.Rejected):
        stark.verify(rec, st.cell.config, st.rows)


@pytest.fixture(scope="module")
def plonk_proof(tmp_path_factory):
    import json
    from pathlib import Path
    config = tiny(json.loads((Path(fib_statement.__file__).parents[1] / "configs"
                              / "plonk_std_recursion.json").read_text()), 4, 2)
    cell = _Cell(config, {"m": 2}, MATMUL_2_KEY)
    cell.cache_dir = tmp_path_factory.mktemp("cache")
    st = matmul_statement.Statement(cell, "cpu")
    st.setup({}, lambda: 0.0)
    return st, st.prove(0, None)


def test_matmul_targets_are_the_builders():
    from plonky2_tpu_torch.models.matrix_mul import build_matrix_mul_circuit
    _, a, b = build_matrix_mul_circuit(3, device="cpu")
    m, m2 = 3, 9
    assert a == [[-(i * m + j + 1) for j in range(m)] for i in range(m)]
    assert b == [[-(m2 + i * m + j + 1) for j in range(m)] for i in range(m)]


def test_plonk_reference_accepts_and_rejects(plonk_proof):
    st, proof = plonk_proof
    assert st.public_ok(0, proof)
    st.verify(proof)
    rec = matmul_statement.record(proof)
    rec["openings"]["wires"] = rec["openings"]["wires"].copy()
    rec["openings"]["wires"][7, 0] ^= np.uint64(1)
    with pytest.raises(plonk.Rejected):
        plonk.verify(rec, st.circuit, st.cell.config)
    rec = matmul_statement.record(proof)
    rec["public_inputs"] = rec["public_inputs"].copy()
    rec["public_inputs"][5] ^= np.uint64(1)
    with pytest.raises(plonk.Rejected):
        plonk.verify(rec, st.circuit, st.cell.config)


def test_plonk_reference_checks_the_pinned_key(plonk_proof):
    st, _ = plonk_proof
    plonk.check_circuit(st.circuit, MATMUL_2_KEY)
    bad = dict(MATMUL_2_KEY, circuit_digest=[1, 2, 3, 4])
    with pytest.raises(plonk.Rejected):
        plonk.check_circuit(st.circuit, bad)
    bad = dict(MATMUL_2_KEY, gates=MATMUL_2_KEY["gates"][:-1])
    with pytest.raises(plonk.Rejected):
        plonk.check_circuit(st.circuit, bad)
