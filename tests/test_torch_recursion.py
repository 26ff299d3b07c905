"""The port's recursion layer and circuit-data checkpoints
(plonky2_tpu_torch.recursion, utils/serialization.py) against the JAX
package on the CPU.

Tier-1 tests prove nothing with the JAX package: the in-circuit challenger
against the JAX package's host Challenger; the production-config wrapper's
gate counts against the JAX package's gadgets on the same inner shape; the
port wrapping tests/test_recursion.py's inner proof (4-query config),
verifying it and rejecting a tampered inner proof; and the
tests/test_circuit_checkpoint.py circuit's checkpoint (the port's bytes
equal the JAX package's, a JAX-written blob proves in the port as the
port's own circuit does, and the JAX circuit's verifier data set into a
port wrapper of the circuit's proofs gives the port's wrapper witness).

The ``slow`` tests hold proofs byte for byte against live JAX proves: the
4-query wrap and the checkpoint circuit here, cyclic recursion, STARK,
staged and aggregation recursion in tests/test_torch_aggregation.py.
"""

import collections

import numpy as np
import pytest
import torch

from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JFriReductionStrategy
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.plonk.builder import CircuitBuilder as JCircuitBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.plonk.witness import PartialWitness as JPartialWitness
from plonky2_tpu.recursion import add_virtual_proof_with_pis as jadd_virtual_proof
from plonky2_tpu.recursion import add_virtual_verifier_data as jadd_virtual_vd
from plonky2_tpu.recursion import set_proof_with_pis_target as jset_proof
from plonky2_tpu.recursion import set_verifier_data_target as jset_vd
from plonky2_tpu.recursion import verify_proof_circuit as jverify_proof_circuit
from plonky2_tpu.utils import serialization as jser
from plonky2_tpu_torch.field import gl64
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.iop.challenger import RecursiveChallenger
from plonky2_tpu_torch.models.bench_recursion import (add_wrapper_gates,
                                                      build_wrapper,
                                                      dummy_inner,
                                                      recursion_config,
                                                      wrapper_witness)
from plonky2_tpu_torch.plonk.builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.witness import PartialWitness
from plonky2_tpu_torch.recursion import dummy_circuit
from plonky2_tpu_torch.utils.serialization import (circuit_data_from_bytes,
                                                   circuit_data_to_bytes,
                                                   common_data_to_bytes,
                                                   proof_with_pis_to_bytes)

P = gl64.ORDER_INT
SEED = 5   # witness-schedule seed of the PI gate's random wires, both sides

# the production wrappers (rate 3, cap height 4, arity 16, 28 queries, 16
# PoW bits) of a 2^12-gate inner proof (level 0) and of the level-0 proof
# (level 1): the gates placed before build() pads the circuit.  Level 1
# places 4,137 gates, so it pads to 2^13, not to level 0's 2^12.
PRODUCTION_WRAPPER_GATES = [
    {"PoseidonGate": 2775, "ArithmeticExtensionGate": 256,
     "MulExtensionGate": 226, "RandomAccessGate": 196, "ReducingGate": 168,
     "ArithmeticGate": 71, "CosetInterpolationGate": 56, "BaseSumGate": 29,
     "PoseidonMdsGate": 8, "ReducingExtensionGate": 8},
    {"PoseidonGate": 2775, "ArithmeticExtensionGate": 473,
     "MulExtensionGate": 352, "RandomAccessGate": 196, "ReducingGate": 168,
     "ArithmeticGate": 71, "CosetInterpolationGate": 56, "BaseSumGate": 29,
     "ReducingExtensionGate": 9, "PoseidonMdsGate": 8}]


def fast_config(circuit_config, fri_config, strategy, num_query_rounds=4,
                pow_bits=8):
    """tests/test_recursion.py's small_recursion_config, from either
    package; 28 rounds and 16 bits make standard_recursion_config."""
    return circuit_config(fri_config=fri_config(
        rate_bits=3, cap_height=4, proof_of_work_bits=pow_bits,
        reduction_strategy=strategy.constant_arity(4, 5),
        num_query_rounds=num_query_rounds))


def jax_fast_config():
    return fast_config(JCircuitConfig, JFriConfig, JFriReductionStrategy)


def port_fast_config():
    return fast_config(CircuitConfig, FriConfig, FriReductionStrategy)


def build_inner(builder_cls, config, **build_kwargs):
    """tests/test_recursion.py's x^2 + y + 42 circuit and its witness."""
    b = builder_cls(config)
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    out = b.add(b.mul(x, x), b.add_const(y, 42))
    b.register_public_input(x)
    b.register_public_input(y)
    b.register_public_input(out)
    data = b.build(**build_kwargs)
    pw = (JPartialWitness if builder_cls is JCircuitBuilder
          else PartialWitness)()
    pw.set_target(x, 3)
    pw.set_target(y, 5)
    return data, pw


def prove_seeded(data, pw):
    data.prover_only.schedule.rng_seed = SEED
    return data.prove(pw)


@pytest.fixture(scope="module")
def port_wrap():
    """The port's inner proof and its 4-query wrapper, both on the CPU:
    (inner data, inner proof, wrapper data, proof target, vd target,
    wrapper proof)."""
    config = port_fast_config()
    inner, pw = build_inner(CircuitBuilder, config, device="cpu")
    inner_proof = prove_seeded(inner, pw)
    inner.verify(inner_proof)
    outer, pt, vdt = build_wrapper(config, inner.common, "cpu")
    outer_proof = prove_seeded(
        outer, wrapper_witness(pt, vdt, inner_proof, inner.verifier_only))
    return inner, inner_proof, outer, pt, vdt, outer_proof


def test_recursive_challenger_matches_host_challenger():
    """Observe elements, a hash and extension elements in-circuit and
    squeeze: the witness values equal the JAX package's host Challenger's
    challenges on the same elements."""
    rng = np.random.default_rng(11)
    values = [int(v) for v in rng.integers(0, P, size=23, dtype=np.uint64)]
    b = CircuitBuilder(port_fast_config())
    ts = b.add_virtual_targets(len(values))
    ch = RecursiveChallenger(b)
    ch.observe_elements(ts[:5])
    first = ch.get_n_challenges(3)
    ch.observe_hash(ts[5:9])
    ch.observe_extension_element((ts[9], ts[10]))
    ext = ch.get_extension_challenge()
    ch.observe_elements(ts[11:])
    rest = ch.get_n_challenges(10)
    state = ch.compact()
    outs = first + list(ext) + rest + state
    b.register_public_inputs(outs)
    data = b.build("cpu")
    pw = PartialWitness()
    for t, v in zip(ts, values):
        pw.set_target(t, v)
    _, all_values = data.prover_only.schedule.generate(pw)
    got = gl64.to_canonical(data.prover_only.schedule.values_of(all_values, outs))

    jch = JChallenger()
    jch.observe_elements(np.array(values[:5], np.uint64))
    want = list(jch.get_n_challenges(3))
    jch.observe_hash(np.array(values[5:9], np.uint64))
    jch.observe_extension_element(np.array(values[9:11], np.uint64))
    want += list(jch.get_extension_challenge())
    jch.observe_elements(np.array(values[11:], np.uint64))
    want += list(jch.get_n_challenges(10))
    want += list(jch.compact())
    assert [int(v) for v in got] == [int(v) % P for v in want]


@pytest.fixture(scope="module")
def production_commons():
    """The common data of bench_recursion's 2^12-gate inner circuit and of
    its level-0 wrapper, built by the port on the CPU (no prove)."""
    config = recursion_config()
    inner, _ = dummy_inner(config, 12, device="cpu")
    level0, _, _ = build_wrapper(config, inner.common, "cpu")
    return inner.common, level0.common


@pytest.mark.parametrize("level", [0, 1])
def test_production_wrapper_gate_counts_match_jax(production_commons, level):
    """The standard-config wrapper of each level places the same gates,
    type by type, in the port as the JAX package's gadgets do on the same
    inner shape (the JAX side reads the port's common data through its own
    checkpoint reader: no JAX build or prove)."""
    inner_common = production_commons[level]
    assert inner_common.degree() == 1 << 12
    b = CircuitBuilder(recursion_config())
    add_wrapper_gates(b, inner_common)
    port_counts = collections.Counter(
        type(g).__name__ for g, _ in b.gate_instances)

    jcommon = jser.common_data_from_bytes(common_data_to_bytes(inner_common))
    jb = JCircuitBuilder(jcommon.config)
    pt = jadd_virtual_proof(jb, jcommon)
    vdt = jadd_virtual_vd(jb, jcommon.config.fri_config.cap_height)
    jverify_proof_circuit(jb, pt, vdt, jcommon)
    jax_counts = collections.Counter(
        type(g).__name__ for g, _ in jb.gate_instances)
    assert port_counts == jax_counts
    assert dict(port_counts) == PRODUCTION_WRAPPER_GATES[level]


def test_port_wrap_verifies_and_exposes_inner_public_inputs(port_wrap):
    inner, inner_proof, outer, _, _, outer_proof = port_wrap
    assert int(inner_proof.public_inputs[2]) == 3 * 3 + 5 + 42
    outer.verify(outer_proof)
    assert list(map(int, outer_proof.public_inputs)) == \
        list(map(int, inner_proof.public_inputs))


def test_port_wrap_rejects_tampered_inner_proof(port_wrap):
    """A wrapper witness made from an inner proof with a changed public
    input gives a wrapper proof that the verifier rejects."""
    inner, inner_proof, outer, pt, vdt, _ = port_wrap
    tampered = type(inner_proof)(
        inner_proof.proof,
        np.array(inner_proof.public_inputs, dtype=np.uint64))
    tampered.public_inputs[2] += np.uint64(1)
    pw = wrapper_witness(pt, vdt, tampered, inner.verifier_only)
    with pytest.raises(AssertionError):
        outer.verify(outer.prove(pw))


def checkpoint_circuit(builder_cls, config, **build_kwargs):
    """tests/test_circuit_checkpoint.py's circuit: several generator kinds,
    named custom generators and a lookup table."""
    b = builder_cls(config)
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    out = b.add(b.mul(x, x), b.add_const(y, 42))
    bits = b.split_le(out, 32)
    picked = b.random_access(b.constant(3), bits[:4])
    ext = b.inverse_extension((x, y))
    lut = tuple((i, (i * i + 1) % 97) for i in range(16))
    lut_index = b.add_lookup_table_from_pairs(lut)
    lo = b.add_lookup_from_index(x, lut_index)
    b.register_public_inputs([x, y, out, picked, ext[0], lo])
    return b.build(**build_kwargs), x, y


def checkpoint_witness(x, y, pw_cls=PartialWitness):
    pw = pw_cls()
    pw.set_target(x, 3)
    pw.set_target(y, 5)
    return pw


@pytest.fixture(scope="module")
def port_checkpoint():
    """The port's checkpoint circuit on the CPU, its blob and its proof."""
    data, x, y = checkpoint_circuit(CircuitBuilder, port_fast_config(),
                                    device="cpu")
    blob = circuit_data_to_bytes(data)    # before the seed is set
    proof = prove_seeded(data, checkpoint_witness(x, y))
    return data, x, y, blob, proof


@pytest.fixture(scope="module")
def jax_checkpoint():
    """The JAX package's build of the same circuit and its checkpoint."""
    data, x, y = checkpoint_circuit(JCircuitBuilder, jax_fast_config())
    return data, x, y, jser.circuit_data_to_bytes(data)


def test_jax_verifier_data_gives_the_same_wrapper_witness(port_checkpoint,
                                                         jax_checkpoint):
    """The verifier data of the JAX-built checkpoint circuit, set into a
    port wrapper of that circuit's proofs, gives the wire values the port's
    own verifier data does."""
    data, _, _, _, proof = port_checkpoint
    jdata = jax_checkpoint[0]
    assert np.array_equal(jdata.verifier_only.circuit_digest,
                          data.verifier_only.circuit_digest)
    outer, pt, vdt = build_wrapper(port_fast_config(), data.common, "cpu")
    schedule = outer.prover_only.schedule
    schedule.rng_seed = SEED
    want, _ = schedule.generate(
        wrapper_witness(pt, vdt, proof, data.verifier_only))
    got, _ = schedule.generate(
        wrapper_witness(pt, vdt, proof, jdata.verifier_only))
    assert np.array_equal(gl64.to_canonical(got), gl64.to_canonical(want))


def test_checkpoint_round_trip_proves(port_checkpoint):
    """tests/test_circuit_checkpoint.py through the port: prove from the
    reloaded data, both verifiers accept, the blob re-encodes unchanged,
    and the proof equals the original circuit's."""
    data, x, y, blob, proof = port_checkpoint
    data2 = circuit_data_from_bytes(blob, device="cpu")
    commitment = data2.prover_only.constants_sigmas_commitment
    assert commitment.polynomials.device == torch.device("cpu")
    assert circuit_data_to_bytes(data2) == blob
    proof2 = prove_seeded(data2, checkpoint_witness(x, y))
    assert int(proof2.public_inputs[2]) == 3 * 3 + 5 + 42
    assert int(proof2.public_inputs[5]) == (3 * 3 + 1) % 97
    data.verify(proof2)
    data2.verify(proof2)
    assert proof_with_pis_to_bytes(proof2) == proof_with_pis_to_bytes(proof)


def test_checkpoint_bytes_equal_jax(port_checkpoint, jax_checkpoint):
    """The blob of the port's build equals the JAX package's, though the
    port's constants commitment keeps its LDE as the tree's leaf columns
    (no leaf-row copy), and a blob read back keeps them so too."""
    data, _, _, blob, _ = port_checkpoint
    assert blob == jax_checkpoint[3]
    batch = data.prover_only.constants_sigmas_commitment
    assert batch.merkle_tree.columns.v.data_ptr() == \
        batch.lde_values.v.data_ptr()
    read = circuit_data_from_bytes(jax_checkpoint[3], device="cpu")
    batch2 = read.prover_only.constants_sigmas_commitment
    assert batch2.merkle_tree.columns.v.data_ptr() == \
        batch2.lde_values.v.data_ptr()
    assert batch2.merkle_tree.cap == batch.merkle_tree.cap
    assert np.array_equal(batch2.lde_values.to_u64(), batch.lde_values.to_u64())


def test_jax_checkpoint_proves_in_the_port(port_checkpoint, jax_checkpoint):
    """A blob the JAX package wrote, read onto the port's CPU device,
    proves byte for byte as the port's own build of the circuit."""
    _, x, y, _, want = port_checkpoint
    data = circuit_data_from_bytes(jax_checkpoint[3], device="cpu")
    got = prove_seeded(data, checkpoint_witness(x, y))
    assert proof_with_pis_to_bytes(got) == proof_with_pis_to_bytes(want)


def test_recursion_entry_points_default_to_cuda(monkeypatch, port_wrap,
                                                port_checkpoint):
    """Without a device the checkpoint reader and the dummy circuit go to
    CUDA, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        circuit_data_from_bytes(port_checkpoint[3])
    with pytest.raises(RuntimeError, match="CUDA"):
        dummy_circuit(port_wrap[0].common)


@pytest.mark.slow
def test_wrap_bytes_match_jax(port_wrap):
    """The 4-query wrap: the JAX package's inner and wrapper proofs, seeded
    as the port's, have the port's bytes."""
    _, inner_proof, _, _, _, outer_proof = port_wrap
    config = jax_fast_config()
    jinner, jpw = build_inner(JCircuitBuilder, config)
    jinner_proof = prove_seeded(jinner, jpw)
    assert jser.proof_with_pis_to_bytes(jinner_proof) == \
        proof_with_pis_to_bytes(inner_proof)
    b = JCircuitBuilder(config)
    pt = jadd_virtual_proof(b, jinner.common)
    vdt = jadd_virtual_vd(b, config.fri_config.cap_height)
    jverify_proof_circuit(b, pt, vdt, jinner.common)
    b.register_public_inputs(pt.public_inputs)
    jouter = b.build()
    pw = JPartialWitness()
    jset_proof(pw, pt, jinner_proof)
    jset_vd(pw, vdt, jinner.verifier_only)
    jouter_proof = prove_seeded(jouter, pw)
    assert jser.proof_with_pis_to_bytes(jouter_proof) == \
        proof_with_pis_to_bytes(outer_proof)


@pytest.mark.slow
def test_checkpoint_proof_matches_jax(port_checkpoint, jax_checkpoint):
    """The checkpoint circuit's proof, seeded alike, is the JAX package's."""
    jdata, jx, jy, _ = jax_checkpoint
    want = prove_seeded(jdata, checkpoint_witness(jx, jy, JPartialWitness))
    assert jser.proof_with_pis_to_bytes(want) == \
        proof_with_pis_to_bytes(port_checkpoint[4])
