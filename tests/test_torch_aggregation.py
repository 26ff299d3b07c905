"""Cyclic, STARK, staged and aggregation recursion in the port
(plonky2_tpu_torch) against the JAX package on the CPU, byte for byte.

Every test here is ``slow``: each proves several recursion circuits of
degree 2^12 to 2^14 in both packages (the JAX package's own tests of these
circuits are slow or heavy too).  Each builds the JAX package's test
circuit (tests/test_cyclic_recursion.py, tests/test_stark_recursion.py,
tests/test_staged_recursion.py, tests/test_zkevm_aggregation.py) in both
packages.  The PI gate's unused wires are the only randomness in these
non-zk proofs, so every witness schedule of both packages, the dummy
circuits' inside the recursion code included, is seeded alike for the
test; the proofs must then be equal.
"""

import numpy as np
import pytest

from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JFriReductionStrategy
from plonky2_tpu.hash.hashing import hash_no_pad_np as jhash_no_pad_np
from plonky2_tpu.plonk.builder import CircuitBuilder as JCircuitBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.plonk.witness import PartialWitness as JPartialWitness
from plonky2_tpu.plonk.witness import WitnessSchedule as JWitnessSchedule
from plonky2_tpu.recursion import add_virtual_proof_with_pis as jadd_virtual_proof
from plonky2_tpu.recursion import set_proof_with_pis_target as jset_proof
from plonky2_tpu.recursion import set_verifier_data_target as jset_vd
from plonky2_tpu.recursion import cyclic as jcyclic
from plonky2_tpu.recursion.dummy import cyclic_base_proof as jcyclic_base_proof
from plonky2_tpu.stark.config import StarkConfig as JStarkConfig
from plonky2_tpu.stark.fibonacci import FibonacciStark as JFibonacciStark
from plonky2_tpu.stark.multi import prove_multi_table as jprove_multi_table
from plonky2_tpu.stark.prover import prove as jprove_stark
from plonky2_tpu.stark import recursive_verifier as jsrv
from plonky2_tpu.stark.staged import prove_staged as jprove_staged
from plonky2_tpu.utils.serialization import proof_with_pis_to_bytes as jto_bytes
from plonky2_tpu.zkevm.aggregation import AllRecursiveCircuits as JAllRecursiveCircuits
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.hash.hashing import hash_no_pad_np
from plonky2_tpu_torch.models.multi_table import aggregation_demo, ctl_demo
from plonky2_tpu_torch.plonk.builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.witness import PartialWitness, WitnessSchedule
from plonky2_tpu_torch.recursion import (add_virtual_proof_with_pis,
                                         set_proof_with_pis_target,
                                         set_verifier_data_target)
from plonky2_tpu_torch.recursion import cyclic
from plonky2_tpu_torch.recursion.dummy import cyclic_base_proof
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
from plonky2_tpu_torch.stark.multi import prove_multi_table
from plonky2_tpu_torch.stark.prover import prove as prove_stark
from plonky2_tpu_torch.stark import recursive_verifier as srv
from plonky2_tpu_torch.stark.staged import prove_staged
from plonky2_tpu_torch.utils.serialization import proof_with_pis_to_bytes
from plonky2_tpu_torch.zkevm.aggregation import AllRecursiveCircuits

from test_ctl import MulStark as JMulStark
from test_ctl import Req2Stark as JReq2Stark
from test_ctl import ReqStark as JReqStark
from test_ctl import _ctls as jctl_demo_ctls
from test_ctl import _mul_trace, _req_traces
from test_zkevm_aggregation import _instance as jaggregation_instance

pytestmark = pytest.mark.slow

SEED = 5


@pytest.fixture(autouse=True)
def seeded_witnesses(monkeypatch):
    """Every witness generation of both packages draws the PI gate's unused
    wires from SEED unless its schedule names a seed."""
    for cls in (JWitnessSchedule, WitnessSchedule):
        def generate(self, pw, _orig=cls.generate):
            seed = self.rng_seed
            self.rng_seed = SEED if seed is None else seed
            try:
                return _orig(self, pw)
            finally:
                self.rng_seed = seed
        monkeypatch.setattr(cls, "generate", generate)


def circuit_config(config_cls, fri_cls, strategy):
    """The reference recursion tests' 4-query circuit config."""
    return config_cls(fri_config=fri_cls(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=strategy.constant_arity(4, 5),
        num_query_rounds=4))


def stark_config(config_cls, fri_cls, strategy):
    """The reference recursion tests' STARK config: rate 1, 8 queries."""
    return config_cls(fri_config=fri_cls(
        rate_bits=1, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=strategy.constant_arity(4, 5),
        num_query_rounds=8))


PORT = {"builder": CircuitBuilder, "pw": PartialWitness,
        "circuit_config": circuit_config(CircuitConfig, FriConfig,
                                         FriReductionStrategy),
        "stark_config": stark_config(StarkConfig, FriConfig,
                                     FriReductionStrategy),
        "add_proof": add_virtual_proof_with_pis,
        "set_proof": set_proof_with_pis_target,
        "set_vd": set_verifier_data_target, "cyclic": cyclic,
        "base_proof": cyclic_base_proof, "hash": hash_no_pad_np,
        "to_bytes": proof_with_pis_to_bytes}
JAX = {"builder": JCircuitBuilder, "pw": JPartialWitness,
       "circuit_config": circuit_config(JCircuitConfig, JFriConfig,
                                        JFriReductionStrategy),
       "stark_config": stark_config(JStarkConfig, JFriConfig,
                                    JFriReductionStrategy),
       "add_proof": jadd_virtual_proof, "set_proof": jset_proof,
       "set_vd": jset_vd, "cyclic": jcyclic,
       "base_proof": jcyclic_base_proof, "hash": jhash_no_pad_np,
       "to_bytes": jto_bytes}


def cyclic_ivc(pkg, **device):
    """tests/test_cyclic_recursion.py's two-step iterated-hash IVC in one
    package: (circuit digest, step proofs' bytes, their public inputs)."""
    config = pkg["circuit_config"]
    cyc = pkg["cyclic"]
    common = cyc.common_data_for_recursion(config, num_extra_pis=9,
                                           min_degree_bits=13, **device)
    b = pkg["builder"](config)
    initial = b.add_virtual_targets(4)
    b.register_public_inputs(initial)
    current_in = b.add_virtual_targets(4)
    b.register_public_inputs(b.hash_n_to_hash_no_pad(list(current_in)))
    counter = b.add_virtual_target()
    b.register_public_input(counter)
    b.add_verifier_data_public_inputs()
    condition = b.add_virtual_target()
    inner_pt = pkg["add_proof"](b, common)
    for t0, t1 in zip(initial, inner_pt.public_inputs[0:4]):
        b.connect(t0, t1)
    for i in range(4):
        b.connect(current_in[i], b.select(
            condition, inner_pt.public_inputs[4 + i], initial[i]))
    b.connect(counter, b.add(inner_pt.public_inputs[8], condition))
    cyc.conditionally_verify_cyclic_proof_or_dummy(b, condition, inner_pt,
                                                   common, *device.values())
    cyc.pad_to_common_degree(b, common)
    data = b.build(*device.values())
    h0 = [1, 2, 3, 4]
    proof = pkg["base_proof"](
        common, data.verifier_only,
        {i: h0[i % 4] for i in range(8)} | {8: 0}, **device)
    proofs = []
    for step in (0, 1):
        pw = pkg["pw"]()
        pw.set_target(condition, step)
        pkg["set_proof"](pw, inner_pt, proof)
        pkg["set_vd"](pw, b.verifier_data_public_input, data.verifier_only)
        proof = data.prove(pw)
        cyc.check_cyclic_proof_verifier_data(proof, data.verifier_only,
                                             common)
        data.verify(proof)
        proofs.append(proof)
    return (np.asarray(data.verifier_only.circuit_digest),
            [pkg["to_bytes"](p) for p in proofs],
            [[int(v) for v in p.public_inputs] for p in proofs])


def test_cyclic_ivc_matches_jax():
    digest, proofs, pis = cyclic_ivc(PORT, device="cpu")
    h1 = hash_no_pad_np(np.array([1, 2, 3, 4], np.uint64))
    h2 = hash_no_pad_np(h1)
    assert pis[0][:9] == [1, 2, 3, 4] + [int(v) for v in h1] + [0]
    assert pis[1][:9] == [1, 2, 3, 4] + [int(v) for v in h2] + [1]
    jdigest, jproofs, jpis = cyclic_ivc(JAX)
    assert np.array_equal(digest, jdigest)
    assert pis == jpis
    assert proofs == jproofs


def stark_wrap(pkg, stark_cls, prove, rv, **device):
    """tests/test_stark_recursion.py: a 2^5-row Fibonacci STARK proof
    wrapped in a plonk circuit; the wrapper proof's bytes."""
    sconfig = pkg["stark_config"]
    stark = stark_cls(1 << 5)
    trace = stark.generate_trace(0, 1)
    pis = np.array([0, 1, stark.expected_result(0, 1)], dtype=np.uint64)
    stark_proof = prove(stark, sconfig, trace, pis, **device)
    b = pkg["builder"](pkg["circuit_config"])
    pt = rv.add_virtual_stark_proof(b, stark, sconfig, 5)
    rv.verify_stark_proof_circuit(b, stark, pt, sconfig, 5)
    b.register_public_inputs(pt.public_inputs)
    data = b.build(*device.values())
    pw = pkg["pw"]()
    rv.set_stark_proof_target(pw, pt, stark_proof)
    proof = data.prove(pw)
    data.verify(proof)
    assert [int(v) for v in proof.public_inputs] == [int(v) for v in pis]
    return pkg["to_bytes"](proof)


def test_stark_wrap_matches_jax():
    got = stark_wrap(PORT, FibonacciStark, prove_stark, srv, device="cpu")
    assert got == stark_wrap(JAX, JFibonacciStark, jprove_stark, jsrv)


def test_staged_root_matches_jax():
    """tests/test_staged_recursion.py's three tables: per-table wrappers
    and their root."""
    starks, ctls, traces = ctl_demo()
    multi = prove_multi_table(starks, ctls, PORT["stark_config"], traces,
                              device="cpu")
    root, root_proof = prove_staged(starks, ctls, multi, PORT["stark_config"],
                                    PORT["circuit_config"], device="cpu")
    root.data.verify(root_proof)

    mul = _mul_trace()
    jstarks = [JMulStark(), JReqStark(), JReq2Stark()]
    jmulti = jprove_multi_table(jstarks, jctl_demo_ctls(),
                                JAX["stark_config"], [mul, *_req_traces(mul)])
    _, jroot_proof = jprove_staged(jstarks, jctl_demo_ctls(), jmulti,
                                   JAX["stark_config"], JAX["circuit_config"])
    assert proof_with_pis_to_bytes(root_proof) == jto_bytes(jroot_proof)


def aggregation_chain(circuits, multi, to_bytes):
    """Root, two aggregations and two chained blocks: their proofs' bytes."""
    root = circuits.prove_root(multi)
    agg1 = circuits.prove_aggregation(root, False, root, False)
    agg2 = circuits.prove_aggregation(agg1, True, root, False)
    blk0 = circuits.prove_block(None, agg2)
    blk1 = circuits.prove_block(blk0, agg2)
    return [to_bytes(p) for p in (root, agg1, agg2, blk0, blk1)]


def test_aggregation_chain_matches_jax():
    """tests/test_zkevm_aggregation.py: the circuits' checkpoint equals the
    JAX package's, and the chain proved through the port's restored
    circuits equals the JAX package's."""
    sconfig = PORT["stark_config"]
    starks, ctls, traces = aggregation_demo()
    multi = prove_multi_table(starks, ctls, sconfig, traces, device="cpu")
    built = AllRecursiveCircuits(starks, ctls, sconfig, multi.degree_bits(),
                                 PORT["circuit_config"], device="cpu")
    blob = built.to_bytes()
    circuits = AllRecursiveCircuits.from_bytes(blob, starks, ctls, sconfig,
                                               device="cpu")
    assert circuits.to_bytes() == blob
    got = aggregation_chain(circuits, multi, proof_with_pis_to_bytes)

    jstarks, jctls, jtraces = jaggregation_instance()
    jmulti = jprove_multi_table(jstarks, jctls, JAX["stark_config"], jtraces)
    jbuilt = JAllRecursiveCircuits(jstarks, jctls, JAX["stark_config"],
                                   jmulti.degree_bits(), JAX["circuit_config"])
    assert jbuilt.to_bytes() == blob
    assert got == aggregation_chain(jbuilt, jmulti, jto_bytes)
