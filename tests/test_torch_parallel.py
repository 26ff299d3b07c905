"""The port's distributed prover (plonky2_tpu_torch.parallel) on a 2-rank
gloo world on the CPU.

One spawned world runs every distributed check of this module (a module
fixture), while this process computes the JAX package's values on the
8-device CPU mesh of its own tests (tests/test_parallel.py,
tests/test_sharded_prover.py, and tests/test_torch_stark.py's 2^5 proof),
so the persistent XLA cache serves both.  Held against the JAX package:
four_step_ntt, dp_lde_and_leaf_hash, sharded_commitment (each rank's
blocks gathered first) and the sharded 2^5 Fibonacci STARK's proof bytes.
Held against the port's single-device prover (computed inside the world,
split between the ranks): the no-permutation STARK, the m = 2 matmul plonk
circuit under tests/test_distributed_plonk.py's fast config, the
multi-table demo proved sharded and through device groups, and the
pipelined stream.  The multi-table and stream checks use LIGHT, a
standard_fast_config with 4 PoW bits and 8 queries, to keep the CPU grind
short; the chip smoke test proves them under standard_fast_config.
The no-permutation variant uses LIGHT too.
"""

import fcntl
import os
import pickle
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from plonky2_tpu_torch.field import gl64, ntt
from plonky2_tpu_torch.field.goldilocks import GF
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.fri.oracle import COSET_SHIFT, PolynomialBatch
from plonky2_tpu_torch.hash.hashing import hash_or_noop
from plonky2_tpu_torch.models import matrix_mul as mm
from plonky2_tpu_torch.models.multi_table import ctl_demo
from plonky2_tpu_torch.parallel import mesh as M
from plonky2_tpu_torch.parallel.distributed import (all_processes_equal,
                                                    initialize, spawn_world)
from plonky2_tpu_torch.parallel.groups import (device_groups,
                                               pipeline_prove_stream)
from plonky2_tpu_torch.parallel.multi_prover import prove_multi_table_sharded
from plonky2_tpu_torch.parallel.prover import sharded_commitment
from plonky2_tpu_torch.plonk.builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.gates.base import GeneratorSpec
from plonky2_tpu_torch.plonk.witness import PartialWitness
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
from plonky2_tpu_torch.stark.multi import prove_multi_table, verify_multi_table
from plonky2_tpu_torch.stark.prover import prove
from plonky2_tpu_torch.stark.verifier import verify_stark_proof
from plonky2_tpu_torch.utils.serialization import (proof_with_pis_from_bytes,
                                                   proof_with_pis_to_bytes,
                                                   stark_proof_from_bytes,
                                                   stark_proof_to_bytes)
from plonky2_tpu_torch.zkevm.serialization import (multi_proof_from_bytes,
                                                   multi_proof_to_bytes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = gl64.ORDER_INT
WORLD = 2
SEED = 5   # witness-schedule seed of the PI gate's random wires
FAST = CircuitConfig(fri_config=FriConfig(
    rate_bits=3, cap_height=4, proof_of_work_bits=8,
    reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
    num_query_rounds=4))
LIGHT = StarkConfig(fri_config=FriConfig(
    rate_bits=1, cap_height=4, proof_of_work_bits=4,
    reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
    num_query_rounds=8))


class NoPermFibonacci(FibonacciStark):
    """The same AIR without its permutation argument."""

    def permutation_pairs(self) -> list:
        return []


def fib(stark_cls, rows, x0=0, x1=1):
    stark = stark_cls(rows)
    pis = np.array([x0, x1, stark.expected_result(x0, x1)], dtype=np.uint64)
    return stark, stark.generate_trace(x0, x1), pis


def matmul_case(device):
    """tests/test_distributed_plonk.py's m = 2 circuit and witness."""
    data, at, bt = mm.build_matrix_mul_circuit(2, FAST, device=device)
    data.prover_only.schedule.rng_seed = SEED
    rng = np.random.default_rng(0)
    a = rng.integers(0, P, size=(2, 2), dtype=np.uint64)
    b = rng.integers(0, P, size=(2, 2), dtype=np.uint64)
    return data, mm.matrix_mul_witness(at, bt, a, b)


def nonce_case(device):
    """A circuit built the default way (no witness seed) whose witness holds
    a fresh random nonce r, drawn at witness generation, in the wires of the
    gates of a * b * r + r: the proof is valid only if every rank commits
    the same r."""
    builder = CircuitBuilder(FAST)
    a, b, r = builder.add_virtual_targets(3)
    builder.add_simple_generator(GeneratorSpec("random", deps=[], outs=[r]))
    c = builder.mul(a, b)
    builder.add(builder.mul(c, r), r)
    builder.register_public_inputs([a, b, c])
    data = builder.build(device)
    assert data.prover_only.schedule.rng_seed is None
    pw = PartialWitness()
    pw.set_target(a, 3)
    pw.set_target(b, 5)
    return data, pw


def stream_case():
    """tests/test_groups.py's stream of three STARKs (at 2^5 rows)."""
    return [fib(FibonacciStark, 1 << 5, a, b) for a, b in [(0, 1), (2, 5), (3, 7)]]


def primitive_inputs():
    rng = np.random.default_rng(0)
    return {"ntt": rng.integers(0, P, size=1 << 10, dtype=np.uint64),
            "lde": rng.integers(0, P, size=(16, 64), dtype=np.uint64),
            "commit": np.random.default_rng(41).integers(
                0, P, size=(16, 64), dtype=np.uint64),
            "small_cap": np.random.default_rng(43).integers(
                0, P, size=(8, 32), dtype=np.uint64)}


def world_checks(mesh):
    """Every distributed check, run on each rank of the world; returns the
    rank's gathered outputs, proof bytes and its share of the
    single-device references."""
    dev = mesh.device
    inp = primitive_inputs()
    out = {"rank": mesh.rank, "size": mesh.size}

    c = M.four_step_ntt(GF.from_u64(inp["ntt"], dev), mesh)
    out["four_step"] = GF(M.all_gather(c.v, mesh, axis=1)).to_u64().reshape(-1)
    d = M.dp_lde_and_leaf_hash(
        M.shard_polys(GF.from_u64(inp["lde"], dev), mesh), 3, 7, mesh)
    out["dp_lde"] = GF(M.all_gather(d.v, mesh)).to_u64()
    cap, leaves = sharded_commitment(
        M.shard_polys(GF.from_u64(inp["commit"], dev), mesh), 3, COSET_SHIFT,
        4, mesh)
    out["commit"] = (cap.data, GF(M.all_gather(leaves.v, mesh)).to_u64())
    cap, _ = sharded_commitment(
        M.shard_polys(GF.from_u64(inp["small_cap"], dev), mesh), 1,
        COSET_SHIFT, 1, mesh)
    out["small_cap"] = cap.data

    # the collectives one by one
    x = torch.arange(8, dtype=torch.int64).reshape(2, 4) + 10 * mesh.rank
    out["all_to_all"] = M.all_to_all(x, mesh).tolist()
    out["roll_left"] = M.roll_left(torch.arange(4) + 4 * mesh.rank, 3,
                                   mesh).tolist()
    out["psum"] = int(M.psum(torch.tensor([mesh.rank + 1]), mesh)[0])
    out["replicated"] = GF(M.broadcast(GF.from_u64(
        np.array([7 + mesh.rank], np.uint64), dev).v, mesh)).to_u64().tolist()
    local = GF.from_u64(np.array([mesh.rank], np.uint64), dev)
    out["host_local"] = (str(local.device), local.to_u64().tolist(),
                         torch.distributed.get_world_size())

    stark, trace, pis = fib(FibonacciStark, 1 << 5)
    out["stark"] = stark_proof_to_bytes(prove(
        stark, StarkConfig.standard_fast_config(), trace, pis, mesh=mesh))
    stark, trace, pis = fib(NoPermFibonacci, 1 << 5)
    out["stark_noperm"] = stark_proof_to_bytes(prove(
        stark, LIGHT, trace, pis, mesh=mesh))
    data, pw = matmul_case(dev)
    out["plonk"] = proof_with_pis_to_bytes(data.prove(pw, mesh=mesh))
    data, pw = nonce_case(dev)
    out["plonk_unseeded"] = proof_with_pis_to_bytes(data.prove(pw, mesh=mesh))
    starks, ctls, traces = ctl_demo()
    out["multi"] = multi_proof_to_bytes(prove_multi_table_sharded(
        starks, ctls, LIGHT, traces, mesh=mesh))
    groups = device_groups(2, mesh)
    out["multi_groups"] = multi_proof_to_bytes(prove_multi_table(
        starks, ctls, LIGHT, traces, mesh_groups=groups))
    cases = stream_case()
    out["stream"] = [stark_proof_to_bytes(p) for p in pipeline_prove_stream(
        cases[0][0], LIGHT, [c[1] for c in cases], [c[2] for c in cases],
        groups)]
    out["equal_same"] = all_processes_equal(out["stark"] + out["plonk"], mesh)
    out["equal_rank"] = all_processes_equal(np.array([mesh.rank]), mesh)

    # the single-device references, half on each rank
    if mesh.rank == 0:
        stark, trace, pis = fib(NoPermFibonacci, 1 << 5)
        out["ref_stark_noperm"] = stark_proof_to_bytes(prove(
            stark, LIGHT, trace, pis, device=dev))
        data, pw = matmul_case(dev)
        out["ref_plonk"] = proof_with_pis_to_bytes(data.prove(pw))
    else:
        out["ref_multi"] = multi_proof_to_bytes(prove_multi_table(
            starks, ctls, LIGHT, traces, device=dev))
        out["ref_stream"] = [stark_proof_to_bytes(prove(s, LIGHT, t, p,
                                                        device=dev))
                             for s, t, p in cases]
    return out


def jax_references():
    """The JAX package's values for the primitives (its mesh functions on
    the 8-device CPU mesh) and its 2^5 Fibonacci proof bytes."""
    from plonky2_tpu.field.goldilocks import GF as JGF
    from plonky2_tpu.fri.oracle import COSET_SHIFT as JCOSET_SHIFT
    from plonky2_tpu.parallel.mesh import (dp_lde_and_leaf_hash,
                                           four_step_ntt, make_mesh,
                                           shard_polys)
    from plonky2_tpu.parallel.prover import sharded_commitment as jcommit
    from plonky2_tpu.stark.config import StarkConfig as JStarkConfig
    from plonky2_tpu.stark.fibonacci import FibonacciStark as JFibonacci
    from plonky2_tpu.stark.prover import prove as jprove
    from plonky2_tpu.utils.serialization import stark_proof_to_bytes as jbytes

    inp = primitive_inputs()
    mesh = make_mesh(8)
    out = {"four_step": np.asarray(
        four_step_ntt(JGF.from_u64(inp["ntt"]), mesh).to_u64()),
        "dp_lde": np.asarray(dp_lde_and_leaf_hash(
            shard_polys(JGF.from_u64(inp["lde"]), mesh), 3, 7,
            mesh).to_u64())}
    cap, leaves = jcommit(shard_polys(JGF.from_u64(inp["commit"]), mesh), 3,
                          JCOSET_SHIFT, 4, mesh)
    out["commit"] = (cap.data, gl64.to_canonical(np.asarray(leaves.to_u64())))
    stark = JFibonacci(1 << 5)
    trace = stark.generate_trace(0, 1)
    pis = np.array([0, 1, stark.expected_result(0, 1)], dtype=np.uint64)
    out["stark"] = jbytes(jprove(stark, JStarkConfig.standard_fast_config(),
                                 trace, pis))
    return out


def _compute_world():
    """(per-rank results, JAX values): the world runs in its own processes
    while this one computes the JAX package's values."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_world, world_checks, WORLD, "gloo",
                            lambda r: "cpu")
        jax_values = jax_references()
        results = ranks.result()
    return results, jax_values


@pytest.fixture(scope="module")
def world(tmp_path_factory, request):
    """The world's results, computed once per test run: under pytest-xdist
    this module's tests may land on several workers, so the first computes
    and stores them (under a file lock, in the run's shared temporary
    directory) and the others read them."""
    if not hasattr(request.config, "workerinput"):
        return _compute_world()
    shared = tmp_path_factory.getbasetemp().parent
    with open(shared / "torch_parallel_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        path = shared / "torch_parallel_world.pkl"
        if path.is_file():
            return pickle.loads(path.read_bytes())
        value = _compute_world()
        path.write_bytes(pickle.dumps(value))
        return value


def both(world, key):
    """The value every rank returned for key (they must agree)."""
    results, _ = world
    first = results[0][key]
    for r in results[1:]:
        if isinstance(first, np.ndarray):
            assert np.array_equal(r[key], first)
        else:
            assert r[key] == first
    return first


def test_four_step_ntt_matches_jax(world):
    _, jax_values = world
    got = both(world, "four_step")
    assert np.array_equal(got, jax_values["four_step"])
    x = primitive_inputs()["ntt"]
    assert np.array_equal(got, ntt.ntt(GF.from_u64(x, "cpu")).to_u64())


def test_dp_lde_and_leaf_hash_matches_jax(world):
    _, jax_values = world
    got = both(world, "dp_lde")
    assert np.array_equal(got, jax_values["dp_lde"])
    polys = GF.from_u64(primitive_inputs()["lde"], "cpu")
    want = hash_or_noop(ntt.lde(polys, 3, shift=7).transpose(1, 0)).to_u64()
    assert np.array_equal(got, want)


def test_sharded_commitment_matches_jax(world):
    _, jax_values = world
    results, _ = world
    for r in results:
        cap, leaves = r["commit"]
        assert np.array_equal(cap, jax_values["commit"][0])
        assert np.array_equal(leaves, jax_values["commit"][1])
    single = PolynomialBatch.from_values(
        GF.from_u64(primitive_inputs()["commit"], "cpu"), 3, False, 4)
    assert np.array_equal(results[0]["commit"][0], single.merkle_tree.cap.data)


def test_sharded_commitment_small_cap(world):
    single = PolynomialBatch.from_values(
        GF.from_u64(primitive_inputs()["small_cap"], "cpu"), 1, False, 1)
    assert np.array_equal(both(world, "small_cap"),
                          single.merkle_tree.cap.data)


def test_collectives(world):
    results, _ = world
    # rank r sends its columns block j to rank j
    assert results[0]["all_to_all"] == [[0, 1], [4, 5], [10, 11], [14, 15]]
    assert results[1]["all_to_all"] == [[2, 3], [6, 7], [12, 13], [16, 17]]
    assert results[0]["roll_left"] == [3, 4, 5, 6]
    assert results[1]["roll_left"] == [7, 0, 1, 2]
    assert [r["psum"] for r in results] == [3, 3]
    assert [r["replicated"] for r in results] == [[7], [7]]
    assert [r["host_local"] for r in results] == [("cpu", [0], 2),
                                                  ("cpu", [1], 2)]


def test_sharded_stark_2e5_matches_jax(world):
    _, jax_values = world
    blob = both(world, "stark")
    assert blob == jax_values["stark"]
    stark = FibonacciStark(1 << 5)
    verify_stark_proof(stark, stark_proof_from_bytes(blob),
                       StarkConfig.standard_fast_config(), 5)


def test_sharded_stark_no_permutations(world):
    results, _ = world
    blob = both(world, "stark_noperm")
    assert blob == results[0]["ref_stark_noperm"]
    verify_stark_proof(NoPermFibonacci(1 << 5), stark_proof_from_bytes(blob),
                       LIGHT, 5)


def test_sharded_plonk_matches_single_device(world):
    results, _ = world
    blob = both(world, "plonk")
    assert blob == results[0]["ref_plonk"]
    data, _ = matmul_case("cpu")
    data.verify(proof_with_pis_from_bytes(blob, data.common))


def test_sharded_plonk_unseeded_witness_verifies(world):
    """Without a witness seed the ranks still prove one witness: the nonce
    circuit's sharded proof verifies."""
    blob = both(world, "plonk_unseeded")
    data, _ = nonce_case("cpu")
    data.verify(proof_with_pis_from_bytes(blob, data.common))


def test_multi_table_sharded_matches_single_device(world):
    results, _ = world
    blob = both(world, "multi")
    assert blob == results[1]["ref_multi"]
    starks, ctls, _ = ctl_demo()
    verify_multi_table(starks, ctls, multi_proof_from_bytes(blob), LIGHT)


def test_multi_table_mesh_groups_matches_single_device(world):
    results, _ = world
    assert both(world, "multi_groups") == results[1]["ref_multi"]


def test_pipeline_stream_matches_sequential(world):
    results, _ = world
    got = both(world, "stream")
    assert got == results[1]["ref_stream"]
    for (stark, _, _), blob in zip(stream_case(), got):
        verify_stark_proof(stark, stark_proof_from_bytes(blob), LIGHT, 5)


def test_all_processes_equal(world):
    results, _ = world
    assert all(r["equal_same"] for r in results)
    assert not any(r["equal_rank"] for r in results)


def _raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    M.psum(torch.ones(1), mesh)   # rank 0 waits in a collective for rank 1
    return mesh.rank


def test_spawn_world_raises_when_a_rank_raises():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn_world(_raise_on_rank_1, WORLD, "gloo", lambda r: "cpu",
                    timeout_s=120)


def test_single_rank_mesh_needs_no_process_group():
    """A mesh of one rank (no process group) proves the 2^5 STARK with the
    single-device bytes."""
    stark, trace, pis = fib(FibonacciStark, 1 << 5)
    got = prove(stark, LIGHT, trace, pis, mesh=M.make_mesh("cpu"))
    want = prove(stark, LIGHT, trace, pis, device="cpu")
    assert stark_proof_to_bytes(got) == stark_proof_to_bytes(want)


def test_initialize_without_a_world_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize()
    assert not torch.distributed.is_initialized()


def test_collectives_only_in_mesh_and_distributed():
    """Every torch.distributed call of the package is in parallel/mesh.py
    or parallel/distributed.py."""
    pkg = os.path.join(ROOT, "plonky2_tpu_torch")
    allowed = {os.path.join(pkg, "parallel", f)
               for f in ("mesh.py", "distributed.py")}
    found = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(dirpath, f)
            if not f.endswith(".py") or path in allowed:
                continue
            with open(path) as fh:
                text = fh.read()
            if re.search(r"torch\.distributed|\bdist\.", text):
                found.append(os.path.relpath(path, ROOT))
    assert not found, found
