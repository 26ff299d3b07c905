"""The port's PLONK prover (plonky2_tpu_torch.plonk) against the JAX package
on the CPU: the same circuit digest, identical proof bytes (the port's own
circuit and one carried across with convert.circuit_data_from_jax), the
port's verifier accepting and rejecting, and a zero-knowledge proof that
verifies; lookup circuits and the keccak hasher config too.

Every comparison runs the JAX package live on the same inputs: one
module-scoped prove of the m = 2 matmul circuit, one of each example
circuit, of tests/test_lookup.py's two-LUT circuit and of
tests/test_keccak_config.py's circuit.  They use those files' fast configs
and circuits, so the persistent XLA cache serves both files.
"""

import copy

import numpy as np
import pytest
import torch

from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JFriReductionStrategy
from plonky2_tpu.models import examples as jexamples
from plonky2_tpu.models import matrix_mul as jmm
from plonky2_tpu.plonk.builder import CircuitBuilder as JCircuitBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.plonk.witness import PartialWitness as JPartialWitness
from plonky2_tpu.utils.serialization import proof_with_pis_to_bytes as jto_bytes
from plonky2_tpu_torch import convert
from plonky2_tpu_torch.field import gl64
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.models import examples
from plonky2_tpu_torch.models import matrix_mul as mm
from plonky2_tpu_torch.plonk.builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.witness import PartialWitness
from plonky2_tpu_torch.utils.serialization import (proof_with_pis_from_bytes,
                                                   proof_with_pis_to_bytes)

P = gl64.ORDER_INT
SEED = 5   # witness-schedule seed of the PI gate's random wires, both sides


def fast_config(circuit_config, fri_config, strategy):
    """tests/test_examples.py's fast_config, from either package."""
    return circuit_config(fri_config=fri_config(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=strategy.constant_arity(4, 5), num_query_rounds=4))


def jax_fast_config():
    return fast_config(JCircuitConfig, JFriConfig, JFriReductionStrategy)


def port_fast_config():
    return fast_config(CircuitConfig, FriConfig, FriReductionStrategy)


def prove_seeded(data, pw):
    data.prover_only.schedule.rng_seed = SEED
    return data.prove(pw)


@pytest.fixture(scope="module")
def matmul_m2():
    """One JAX build and prove of the m = 2 matmul circuit under
    standard_recursion_config: (jax data, its a/b targets, a, b, proof
    bytes)."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, P, size=(2, 2), dtype=np.uint64)
    b = rng.integers(0, P, size=(2, 2), dtype=np.uint64)
    jdata, ja, jb = jmm.build_matrix_mul_circuit(2)
    proof = prove_seeded(jdata, jmm.matrix_mul_witness(ja, jb, a, b))
    return jdata, ja, jb, a, b, jto_bytes(proof)


def test_matmul_m2_matches_jax(matmul_m2):
    jdata, _, _, a, b, want = matmul_m2
    data, at, bt = mm.build_matrix_mul_circuit(2, device="cpu")
    assert np.array_equal(data.verifier_only.circuit_digest,
                          jdata.verifier_only.circuit_digest)
    proof = prove_seeded(data, mm.matrix_mul_witness(at, bt, a, b))
    got = proof_with_pis_to_bytes(proof)
    assert got == want
    back = proof_with_pis_from_bytes(got, data.common)
    assert proof_with_pis_to_bytes(back) == got
    data.verify(back)
    pis = proof.public_inputs.reshape(2, 2, 3)
    np.testing.assert_array_equal(pis[:, :, 2], mm.expected_product(a, b))

    tampered = copy.copy(proof)
    tampered.public_inputs = proof.public_inputs.copy()
    tampered.public_inputs[2] = (int(tampered.public_inputs[2]) + 1) % P
    with pytest.raises(AssertionError):
        data.verify(tampered)


def test_circuit_data_from_jax_proves_identically(matmul_m2):
    jdata, ja, jb, a, b, want = matmul_m2
    data = convert.circuit_data_from_jax(jdata, "cpu")
    assert data.prover_only.constants_sigmas_commitment.polynomials.device.type == "cpu"
    # the JAX circuit's targets index the carried-across schedule
    proof = prove_seeded(data, mm.matrix_mul_witness(ja, jb, a, b))
    assert proof_with_pis_to_bytes(proof) == want
    data.verify(proof)


def _fibonacci(mod, config, device=None):
    data, ta, tb = (mod.fibonacci_circuit(100, config) if device is None
                    else mod.fibonacci_circuit(100, config, device))
    return data, {ta: 0, tb: 1}


def _range_check(mod, config, device=None):
    data, value = (mod.range_check_circuit(32, config) if device is None
                   else mod.range_check_circuit(32, config, device))
    return data, {value: (1 << 32) - 1}


EXAMPLES = {"fibonacci": _fibonacci, "range_check": _range_check}


def jax_example_proof_bytes(make) -> bytes:
    """The JAX package's proof of an example circuit under fast_config."""
    jdata, jinputs = make(jexamples, jax_fast_config())
    jpw = JPartialWitness()
    for t, v in jinputs.items():
        jpw.set_target(t, v)
    return jto_bytes(prove_seeded(jdata, jpw))


@pytest.fixture(scope="module", params=sorted(EXAMPLES))
def example(request):
    """(name, the JAX package's proof bytes) for each example circuit."""
    return request.param, jax_example_proof_bytes(EXAMPLES[request.param])


def test_examples_match_jax(example):
    name, want = example
    config = port_fast_config()
    assert convert.circuit_config_from_jax(jax_fast_config()) == config
    data, inputs = EXAMPLES[name](examples, config, "cpu")
    pw = PartialWitness()
    for t, v in inputs.items():
        pw.set_target(t, v)
    proof = prove_seeded(data, pw)
    assert proof_with_pis_to_bytes(proof) == want
    data.verify(proof)


def test_zk_proof_verifies():
    """Salted commitments draw os.urandom, so a zk proof is checked by
    verification only: m = 2 under tests/test_zk.py's zk config (2 queries).
    Under standard_recursion_zk_config blinding takes the circuit to 2^14
    rows, minutes on the CPU; chip_smoke.py proves and verifies that one on
    the card."""
    config = CircuitConfig(zero_knowledge=True, fri_config=FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
        num_query_rounds=2))
    data, at, bt = mm.build_matrix_mul_circuit(2, config, device="cpu")
    rng = np.random.default_rng(1)
    a = rng.integers(0, P, size=(2, 2), dtype=np.uint64)
    b = rng.integers(0, P, size=(2, 2), dtype=np.uint64)
    proof = data.prove(mm.matrix_mul_witness(at, bt, a, b))
    assert data.common.fri_params.hiding
    salted = proof.proof.opening_proof.query_round_proofs[0]
    assert len(salted.initial_trees_proof.evals_proofs[1][0]) == \
        config.num_wires + 4   # wires + SALT_SIZE salt columns
    data.verify(proof)


def test_lookup_circuits_are_not_proved_yet():
    """Lookup circuits are proved now: a one-LUT circuit proves on the CPU
    and verifies, with the LUT's output as its public input."""
    b = CircuitBuilder(port_fast_config())
    lut = b.add_lookup_table_from_fn(lambda x: (x * x) & 0xFFFF, range(4))
    x = b.add_virtual_target()
    b.register_public_input(b.add_lookup_from_index(x, lut))
    data = b.build("cpu")
    pw = PartialWitness()
    pw.set_target(x, 3)
    proof = data.prove(pw)
    assert list(map(int, proof.public_inputs)) == [9]
    assert len(proof.proof.openings.lookup_zs_next) == \
        data.common.num_all_lookup_polys() > 0
    data.verify(proof)


TIP5_IN = list(range(8))
TIP5_OUT = [y & 0xFFFF for y in (0xDEAD, 0xBEEF, 17, 255, 0, 3, 7, 8)]


def two_luts_circuit(builder, config, device=None):
    """tests/test_lookup.py's test_two_luts_and_fn_table circuit."""
    b = builder(config)
    lut_a = b.add_lookup_table_from_table(TIP5_IN, TIP5_OUT)
    lut_b = b.add_lookup_table_from_fn(lambda x: (x * x + 1) & 0xFFFF,
                                       list(range(16)))
    x = b.add_virtual_target()
    y = b.add_lookup_from_index(x, lut_a)
    s = b.add_lookup_from_index(b.constant(7), lut_b)
    b.register_public_inputs([x, y, s, b.add(y, s)])
    return (b.build() if device is None else b.build(device)), x


@pytest.fixture(scope="module")
def jax_two_luts_bytes():
    jdata, jx = two_luts_circuit(JCircuitBuilder, jax_fast_config())
    jpw = JPartialWitness()
    jpw.set_target(jx, 6)
    return jto_bytes(prove_seeded(jdata, jpw))


def test_lookup_proof_matches_jax(jax_two_luts_bytes):
    data, x = two_luts_circuit(CircuitBuilder, port_fast_config(), "cpu")
    pw = PartialWitness()
    pw.set_target(x, 6)
    proof = prove_seeded(data, pw)
    assert list(map(int, proof.public_inputs)) == [6, 7, 50, 57]
    got = proof_with_pis_to_bytes(proof)
    assert got == jax_two_luts_bytes
    back = proof_with_pis_from_bytes(got, data.common)
    data.verify(back)


def test_lookup_rejects_wrong_claim():
    """tests/test_lookup.py's case: a lookup output pinned to a value the
    LUT does not hold cannot give a proof that verifies."""
    b = CircuitBuilder(port_fast_config())
    lut = b.add_lookup_table_from_table(TIP5_IN, TIP5_OUT)
    inp = b.add_virtual_target()
    out = b.add_lookup_from_index(inp, lut)
    b.connect(out, b.constant(12345))   # contradicts LUT[3] = 255
    b.register_public_inputs([inp, out])
    data = b.build("cpu")
    pw = PartialWitness()
    pw.set_target(inp, 3)
    with pytest.raises(AssertionError):
        data.verify(data.prove(pw))


def keccak_circuit(builder, config, device=None):
    """tests/test_keccak_config.py's circuit: out = x*x + (y + 42)."""
    b = builder(config)
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_public_inputs([x, y, b.add(b.mul(x, x), b.add_const(y, 42))])
    return (b.build() if device is None else b.build(device)), x, y


def keccak_config(circuit_config, fri_config, strategy):
    """tests/test_keccak_config.py's _config(), from either package."""
    return circuit_config(hasher="keccak", fri_config=fri_config(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=strategy.constant_arity(4, 5), num_query_rounds=4))


@pytest.fixture(scope="module")
def jax_keccak():
    """(JAX circuit data, x, y, proof bytes) of the keccak-config circuit."""
    jdata, jx, jy = keccak_circuit(
        JCircuitBuilder,
        keccak_config(JCircuitConfig, JFriConfig, JFriReductionStrategy))
    jpw = JPartialWitness()
    jpw.set_target(jx, 3)
    jpw.set_target(jy, 5)
    return jdata, jx, jy, jto_bytes(prove_seeded(jdata, jpw))


def test_keccak_config_proof_matches_jax(jax_keccak):
    jdata, _, _, want = jax_keccak
    config = keccak_config(CircuitConfig, FriConfig, FriReductionStrategy)
    data, x, y = keccak_circuit(CircuitBuilder, config, "cpu")
    assert data.verifier_only.circuit_digest.dtype == np.uint8
    np.testing.assert_array_equal(data.verifier_only.circuit_digest,
                                  jdata.verifier_only.circuit_digest)
    pw = PartialWitness()
    pw.set_target(x, 3)
    pw.set_target(y, 5)
    proof = prove_seeded(data, pw)
    assert proof.proof.wires_cap.data.dtype == np.uint8
    got = proof_with_pis_to_bytes(proof)
    assert got == want
    back = proof_with_pis_from_bytes(got, data.common)
    assert proof_with_pis_to_bytes(back) == got
    data.verify(back)
    tampered = copy.copy(proof)
    tampered.public_inputs = proof.public_inputs.copy()
    tampered.public_inputs[2] = (int(tampered.public_inputs[2]) + 1) % P
    with pytest.raises(AssertionError):
        data.verify(tampered)


def test_keccak_circuit_data_from_jax_proves_identically(jax_keccak):
    jdata, jx, jy, want = jax_keccak
    data = convert.circuit_data_from_jax(jdata, "cpu")
    pw = PartialWitness()
    pw.set_target(jx, 3)
    pw.set_target(jy, 5)
    assert proof_with_pis_to_bytes(prove_seeded(data, pw)) == want


def test_build_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        examples.fibonacci_circuit(4, port_fast_config())
