"""The port's Fibonacci STARK prove (plonky2_tpu_torch.stark) against the JAX
package on the CPU: identical proof bytes, each verifier accepting the
other's proofs, and the port's own structure (no jax, CUDA by default)."""

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from plonky2_tpu.stark.config import StarkConfig as JStarkConfig
from plonky2_tpu.stark.fibonacci import FibonacciStark as JFibonacciStark
from plonky2_tpu.stark.prover import prove as jprove
from plonky2_tpu.stark.verifier import verify_stark_proof as jverify
from plonky2_tpu.utils.serialization import stark_proof_from_bytes as jfrom_bytes
from plonky2_tpu.utils.serialization import stark_proof_to_bytes as jto_bytes
from plonky2_tpu_torch import convert
from plonky2_tpu_torch.field import gl64
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
from plonky2_tpu_torch.stark.prover import prove
from plonky2_tpu_torch.stark.verifier import verify_stark_proof
from plonky2_tpu_torch.utils.serialization import (stark_proof_from_bytes,
                                                   stark_proof_to_bytes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the modules of the plonk slice, each imported with jax blocked
PLONK_SLICE_MODULES = [
    "plonk.builder", "plonk.circuit_data", "plonk.config", "plonk.gadgets",
    "plonk.generators", "plonk.proof", "plonk.prover", "plonk.targets",
    "plonk.validate_shape", "plonk.vanishing", "plonk.verifier",
    "plonk.witness", "plonk.gates.arithmetic", "plonk.gates.base",
    "plonk.gates.ext_gates", "plonk.gates.interpolation",
    "plonk.gates.lookup", "plonk.gates.misc", "plonk.gates.poseidon_gate",
    "plonk.gates.simple", "models.examples", "models.matrix_mul",
    "utils.context_tree", "utils.serialization", "field.ntt", "convert"]
# the modules of the multi-table STARK / zkEVM / keccak slice
ZKEVM_SLICE_MODULES = [
    "hash.keccak", "hash.keccak_tree", "native", "field.secp256k1",
    "stark.ctl", "stark.multi", "stark.testing", "models.multi_table",
    "zkevm", "zkevm.arithmetic", "zkevm.bn254", "zkevm.cpu",
    "zkevm.generation", "zkevm.keccak", "zkevm.keccak_sponge", "zkevm.logic",
    "zkevm.lookup", "zkevm.memory", "zkevm.mpt", "zkevm.opcodes",
    "zkevm.program", "zkevm.rlp", "zkevm.serialization", "zkevm.transfer",
    "zkevm.kernel", "zkevm.kernel.aggregator", "zkevm.kernel.assembler"]
# the modules of the recursion, aggregation and checkpoint slice
RECURSION_SLICE_MODULES = [
    "iop.challenger", "recursion", "recursion.ctx",
    "recursion.recursive_verifier", "recursion.dummy",
    "recursion.conditional", "recursion.cyclic", "fri.recursive_verifier",
    "models.bench_recursion", "stark.recursive_verifier",
    "stark.multi_recursive", "stark.staged", "zkevm.aggregation"]
# the modules of the distributed prover and the last host modules
PARALLEL_SLICE_MODULES = [
    "plonk.gates.testing", "hash.path_compression", "fri.compression",
    "plonk.compression", "field.towers", "parallel", "parallel.distributed",
    "parallel.mesh", "parallel.prover", "parallel.fri",
    "parallel.stark_prover", "parallel.plonk_prover", "parallel.multi_prover",
    "parallel.groups"]
# the modules of the leaf sponge's redesign and the STARK test harness
SPONGE_SLICE_MODULES = [
    "hash.hashing", "hash.merkle", "fri.oracle", "utils.serialization",
    "parallel.groups", "parallel.mesh", "stark.testing"]


def fib_pis(stark, x0, x1):
    return np.array([x0, x1, stark.expected_result(x0, x1)], dtype=np.uint64)


@pytest.fixture(scope="module")
def jax_proof_2e5():
    """One JAX prove of the 2^5-row Fibonacci STARK: (trace, pis, bytes)."""
    stark = JFibonacciStark(1 << 5)
    trace = stark.generate_trace(0, 1)
    pis = fib_pis(stark, 0, 1)
    proof = jprove(stark, JStarkConfig.standard_fast_config(), trace, pis)
    return trace, pis, jto_bytes(proof)


@pytest.fixture(scope="module")
def port_proof_2e5(jax_proof_2e5):
    """The port's proof of the same trace under the converted config."""
    jtrace, pis, _ = jax_proof_2e5
    config = convert.stark_config_from_jax(JStarkConfig.standard_fast_config())
    trace = convert.gf_from_jax(jtrace, "cpu")
    return prove(FibonacciStark(1 << 5), config, trace, pis, device="cpu")


def test_proof_bytes_equal_jax(jax_proof_2e5, port_proof_2e5):
    assert stark_proof_to_bytes(port_proof_2e5) == jax_proof_2e5[2]


def test_jax_verifier_accepts_port_proof(port_proof_2e5):
    data = stark_proof_to_bytes(port_proof_2e5)
    jverify(JFibonacciStark(1 << 5), jfrom_bytes(data),
            JStarkConfig.standard_fast_config(), 5)
    back = stark_proof_from_bytes(data)
    assert stark_proof_to_bytes(back) == data
    verify_stark_proof(FibonacciStark(1 << 5), back,
                       StarkConfig.standard_fast_config(), 5)


def test_port_verifier_accepts_2e6_and_rejects_wrong_result():
    config = StarkConfig.standard_fast_config()
    stark = FibonacciStark(1 << 6)
    trace = stark.generate_trace(2, 3)
    pis = fib_pis(stark, 2, 3)
    proof = prove(stark, config, trace, pis, device="cpu")
    verify_stark_proof(stark, proof, config, 6)
    bad = pis.copy()
    bad[2] = np.uint64((int(bad[2]) + 1) % gl64.ORDER_INT)
    with pytest.raises(AssertionError):
        verify_stark_proof(stark, dataclasses.replace(proof, public_inputs=bad),
                           config, 6)
    forged = copy.deepcopy(proof)     # one query's opened trace leaf changed
    leaf = forged.proof.opening_proof.query_round_proofs[5].initial_trees_proof
    leaf.evals_proofs[0][0][0] ^= np.uint64(1)
    with pytest.raises(AssertionError, match="initial Merkle"):
        verify_stark_proof(stark, forged, config, 6)


def test_prove_defaults_to_cuda(monkeypatch):
    stark = FibonacciStark(1 << 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prove(stark, StarkConfig.standard_fast_config(),
              stark.generate_trace(0, 1), fib_pis(stark, 0, 1))


def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import plonky2_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(plonky2_tpu_torch.__path__, "
        "'plonky2_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'plonky2_tpu' "
        "or m.startswith('plonky2_tpu.')]\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {PLONK_SLICE_MODULES + ZKEVM_SLICE_MODULES + RECURSION_SLICE_MODULES + PARALLEL_SLICE_MODULES + SPONGE_SLICE_MODULES!r} "
        "if 'plonky2_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print('clean', len([m for m in sys.modules "
        "if m.startswith('plonky2_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_port_has_every_module_of_the_jax_package():
    """Every module of plonky2_tpu/ outside ops/ (the Pallas kernels, whose
    counterparts are csrc/) has a module of the same path in
    plonky2_tpu_torch/; walks both trees by file name, importing neither."""
    def modules(pkg):
        root = os.path.join(ROOT, pkg)
        out = set()
        for dirpath, _, files in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            if rel.split(os.sep)[0] in ("ops", "__pycache__", "_build"):
                continue
            for f in files:
                if f.endswith(".py"):
                    out.add(os.path.normpath(os.path.join(rel, f)))
        return out
    jax_modules = modules("plonky2_tpu")
    assert "parallel/groups.py" in jax_modules
    assert not jax_modules - modules("plonky2_tpu_torch")


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
