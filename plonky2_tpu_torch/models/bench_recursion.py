"""Recursion benchmark CLI (twin of reference plonky2/examples/bench_recursion.rs).

Builds a dummy proof with ~2^size gates, then a chain of recursive wrapper
proofs, reporting per-phase timings and proof sizes.  Circuits are built
and proved on ``--device`` (CUDA by default):

    python -m plonky2_tpu_torch.models.bench_recursion --size 12 --levels 1 \
        --query-rounds 4 --pow-bits 8 --device cpu
"""

from __future__ import annotations

import argparse
import time

from ..fri.config import FriConfig, FriReductionStrategy
from ..plonk.builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..plonk.gates.simple import NoopGate
from ..plonk.witness import PartialWitness
from ..recursion import (add_virtual_proof_with_pis, add_virtual_verifier_data,
                         set_proof_with_pis_target, set_verifier_data_target,
                         verify_proof_circuit)
from ..utils.cuda import resolve_device
from ..utils.serialization import proof_with_pis_to_bytes
from ..utils.timing import TimingTree


def dummy_inner(config: CircuitConfig, size_bits: int, device=None):
    """A circuit with ~2^size_bits NoopGates, built on ``device``, and its
    witness (bench_recursion.rs:199 dummy_proof)."""
    b = CircuitBuilder(config)
    x = b.add_virtual_target()
    b.register_public_input(x)
    while b.num_gates() < (1 << size_bits) - 16:
        b.add_gate(NoopGate(), [])
    data = b.build(device)
    pw = PartialWitness()
    pw.set_target(x, 42)
    return data, pw


def recursion_config(query_rounds: int = 28, pow_bits: int = 16) -> CircuitConfig:
    """The reference's standard_recursion_config (plonk/circuit_data.rs:72)
    at its defaults; fewer query rounds and PoW bits make the test config."""
    return CircuitConfig(fri_config=FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=pow_bits,
        reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
        num_query_rounds=query_rounds))


def add_wrapper_gates(b: CircuitBuilder, inner_common):
    """A verifier of one ``inner_common`` proof in ``b``, its public inputs
    exposed as ``b``'s: returns the proof and verifier-data targets."""
    pt = add_virtual_proof_with_pis(b, inner_common)
    vdt = add_virtual_verifier_data(b, b.config.fri_config.cap_height)
    verify_proof_circuit(b, pt, vdt, inner_common)
    b.register_public_inputs(pt.public_inputs)
    return pt, vdt


def build_wrapper(config: CircuitConfig, inner_common, device=None):
    """The wrapper circuit of one level, built on ``device``: (data, proof
    target, verifier-data target)."""
    b = CircuitBuilder(config)
    pt, vdt = add_wrapper_gates(b, inner_common)
    return b.build(device), pt, vdt


def wrapper_witness(pt, vdt, inner_proof, inner_verifier_only) -> PartialWitness:
    """The wrapper's witness: the inner proof and its verifier data."""
    pw = PartialWitness()
    set_proof_with_pis_target(pw, pt, inner_proof)
    set_verifier_data_target(pw, vdt, inner_verifier_only)
    return pw


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, default=12,
                    help="log2 gates of the inner dummy circuit")
    ap.add_argument("--levels", type=int, default=1,
                    help="number of recursive wrapping levels")
    ap.add_argument("--query-rounds", type=int, default=28)
    ap.add_argument("--pow-bits", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device to build and prove on (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    config = recursion_config(args.query_rounds, args.pow_bits)

    t0 = time.perf_counter()
    data, pw = dummy_inner(config, args.size, device)
    print(f"inner circuit build ({data.common.degree()} gates): "
          f"{time.perf_counter() - t0:.2f}s")

    timing = TimingTree("prove inner", device)
    proof = data.prove(pw, timing)
    timing.print()
    data.verify(proof)
    print(f"inner proof: {len(proof_with_pis_to_bytes(proof))} bytes")

    for level in range(args.levels):
        t0 = time.perf_counter()
        outer, pt, vdt = build_wrapper(config, data.common, device)
        print(f"level {level}: wrapper build ({outer.common.degree()} gates): "
              f"{time.perf_counter() - t0:.2f}s")

        pw = wrapper_witness(pt, vdt, proof, data.verifier_only)
        timing = TimingTree(f"prove wrapper {level}", device)
        proof = outer.prove(pw, timing)
        timing.print()
        outer.verify(proof)
        print(f"level {level} proof: "
              f"{len(proof_with_pis_to_bytes(proof))} bytes")
        data = outer

    print("done")


if __name__ == "__main__":
    main()
