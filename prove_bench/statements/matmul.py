"""The matrix-multiplication circuit ("I know A B = C", plonky2
src/bin/matrix_mul.rs) through ``CircuitData.prove`` of
``plonky2_tpu_torch``.

Set-up builds the circuit once, or reads it from a checkpoint that an
earlier run in the same checkout wrote under ``prove_bench/cache/`` (the
program's ``circuit_data_to_bytes``), keyed by a hash of the program's
sources and the cell's parameters so that a stale checkpoint is never
read.  Every proof gets fresh A and B, drawn from the seed and the proof's
index, set through the witness."""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from prove_bench.reference import gl64
from prove_bench.reference import plonk as ref
from prove_bench.statements.fib import _fri_record, program_fri_config

P = gl64.ORDER_INT


def sources_hash(package_dir: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(package_dir.rglob("*")):
        if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".cpp", ".asm") \
                and "_build" not in p.parts and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(package_dir)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:20]


class Statement:
    def __init__(self, cell, device):
        self.cell = cell
        self.device = device
        self.m = int(cell.traffic["m"])

    def program_config(self, config: dict):
        from plonky2_tpu_torch.plonk.config import CircuitConfig
        keys = ("num_wires", "num_routed_wires", "num_constants",
                "use_base_arithmetic_gate", "security_bits", "num_challenges",
                "zero_knowledge", "max_quotient_degree_factor", "hasher")
        return CircuitConfig(fri_config=program_fri_config(config["fri"]),
                             **{k: config[k] for k in keys})

    def setup(self, parts: dict, clock, config: dict | None = None) -> None:
        import plonky2_tpu_torch
        from plonky2_tpu_torch.models.matrix_mul import build_matrix_mul_circuit
        from plonky2_tpu_torch.utils.serialization import (circuit_data_from_bytes,
                                                           circuit_data_to_bytes)
        config = config or self.cell.config
        program_config = self.program_config(config)
        key = hashlib.sha256(json.dumps(
            [sources_hash(Path(plonky2_tpu_torch.__file__).parent), config, self.m,
             str(self.device)], sort_keys=True).encode()).hexdigest()[:24]
        path = self.cell.cache_dir / "circuits" / f"matmul_{self.m}_{key}.bin"
        t = clock()
        if path.exists():
            self.data = circuit_data_from_bytes(path.read_bytes(), device=self.device)
            parts["circuit_load_s"] = clock() - t
        else:
            self.data, _, _ = build_matrix_mul_circuit(self.m, program_config,
                                                       device=self.device)
            parts["circuit_build_s"] = clock() - t
            t = clock()
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_bytes(circuit_data_to_bytes(self.data))
            os.replace(tmp, path)
            parts["circuit_save_s"] = clock() - t
        parts["circuit_bytes"] = path.stat().st_size
        # the builder makes A's targets, then B's, before any other target
        # (models/matrix_mul.py): virtual targets -(k + 1)
        m2 = self.m * self.m
        self.a_targets = [[-(i * self.m + j + 1) for j in range(self.m)]
                          for i in range(self.m)]
        self.b_targets = [[-(m2 + i * self.m + j + 1) for j in range(self.m)]
                          for i in range(self.m)]
        self.data.prover_only.schedule.rng_seed = self.cell.seed % (1 << 63)
        self.circuit = circuit_record(self.data)

    def draw(self, i: int):
        rng = np.random.default_rng([self.cell.seed, i + 1])
        a = rng.integers(0, P, (self.m, self.m), dtype=np.uint64)
        b = rng.integers(0, P, (self.m, self.m), dtype=np.uint64)
        return a, b

    def prove(self, i: int, timing):
        from plonky2_tpu_torch.models.matrix_mul import matrix_mul_witness
        a, b = self.draw(i)
        pw = matrix_mul_witness(self.a_targets, self.b_targets, a, b)
        return self.data.prove(pw, timing=timing)

    def work(self):
        return None

    def facts(self, proof) -> dict:
        return {"pow_witness": int(proof.proof.opening_proof.pow_witness)}

    def release(self) -> None:
        self.data = None

    # -- judging, with the plain reference ----------------------------------
    def public_ok(self, i: int, proof) -> bool:
        want = ref.matmul_public_inputs(*self.draw(i))
        got = np.asarray(proof.public_inputs, dtype=np.uint64)
        return got.shape == want.shape and bool((got == want).all())

    def verify(self, proof) -> None:
        """Raises ref.Rejected unless the circuit matches the pinned
        verifying key and the reference accepts the proof against it."""
        ref.check_circuit(self.circuit, self.cell.pinned_key())
        ref.verify(record(proof), self.circuit, self.cell.config)


def circuit_record(data) -> dict:
    c = data.common
    return {"gates": [g.id() for g in c.gates],
            "selector_indices": [int(i) for i in c.selectors_info.selector_indices],
            "selector_groups": [[g.start, g.stop] for g in c.selectors_info.groups],
            "num_constants": int(c.num_constants),
            "num_public_inputs": int(c.num_public_inputs),
            "degree_bits": int(c.degree_bits()),
            "constants_sigmas_cap": np.asarray(
                data.verifier_only.constants_sigmas_cap.data, dtype=np.uint64),
            "circuit_digest": np.asarray(data.verifier_only.circuit_digest,
                                         dtype=np.uint64)}


def record(proof) -> dict:
    """The program's proof as the plain record the reference reads."""
    p = proof.proof
    o = p.openings
    return {"public_inputs": np.asarray(proof.public_inputs, dtype=np.uint64),
            "wires_cap": np.asarray(p.wires_cap.data, dtype=np.uint64),
            "zs_cap": np.asarray(p.plonk_zs_partial_products_cap.data, dtype=np.uint64),
            "quotient_cap": np.asarray(p.quotient_polys_cap.data, dtype=np.uint64),
            "openings": {k: np.asarray(getattr(o, k), dtype=np.uint64) for k in (
                "constants", "plonk_sigmas", "wires", "plonk_zs", "plonk_zs_next",
                "partial_products", "quotient_polys")},
            "fri": _fri_record(p.opening_proof)}
