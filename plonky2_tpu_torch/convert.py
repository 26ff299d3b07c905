"""Carry values from the JAX package (plonky2_tpu) into this port.

Everything here duck-types on attributes, so the port needs no import of the
JAX package: a JAX ``GF`` is read through its ``lo``/``hi`` u32 planes, a
host array as u64 values, JAX ``StarkConfig``/``FriConfig``/``CircuitConfig``
objects through their fields, and gates through their ``id()`` strings.
``circuit_data_from_jax`` carries a whole built circuit across (the
"weights" of the plonk path) and re-commits its constants and sigmas on the
port's device.
"""

from __future__ import annotations

import numpy as np

from .field.goldilocks import GF
from .fri.config import FriConfig, FriParams, FriReductionStrategy
from .fri.oracle import PolynomialBatch
from .hash.keccak_tree import BytesMerkleCap
from .hash.merkle import MerkleCap
from .plonk.circuit_data import (CircuitData, CommonCircuitData,
                                 ProverOnlyCircuitData, SelectorsInfo,
                                 VerifierOnlyCircuitData)
from .plonk.config import CircuitConfig
from .plonk.witness import WitnessSchedule
from .stark.config import StarkConfig
from .utils.cuda import resolve_device
from .utils.serialization import (Buffer, gate_from_id, read_schedule,
                                  write_schedule)


def gf_from_jax(x, device) -> GF:
    """A JAX GF (planes ``lo``, ``hi``) or a host u64 array -> port GF."""
    if hasattr(x, "lo") and hasattr(x, "hi"):
        lo = np.asarray(x.lo, dtype=np.uint64)
        hi = np.asarray(x.hi, dtype=np.uint64)
        return GF.from_u64((hi << np.uint64(32)) | lo, device)
    return GF.from_u64(np.asarray(x, dtype=np.uint64), device)


def fri_config_from_jax(cfg) -> FriConfig:
    rs = cfg.reduction_strategy
    return FriConfig(
        rate_bits=cfg.rate_bits,
        cap_height=cfg.cap_height,
        proof_of_work_bits=cfg.proof_of_work_bits,
        reduction_strategy=FriReductionStrategy(
            rs.kind, tuple(rs.arity_bits), rs.final_poly_bits,
            rs.num_queries_hint),
        num_query_rounds=cfg.num_query_rounds,
    )


def stark_config_from_jax(cfg) -> StarkConfig:
    return StarkConfig(
        security_bits=cfg.security_bits,
        num_challenges=cfg.num_challenges,
        fri_config=fri_config_from_jax(cfg.fri_config),
        hasher=cfg.hasher,
    )


def circuit_config_from_jax(cfg) -> CircuitConfig:
    return CircuitConfig(
        num_wires=cfg.num_wires, num_routed_wires=cfg.num_routed_wires,
        num_constants=cfg.num_constants,
        use_base_arithmetic_gate=cfg.use_base_arithmetic_gate,
        security_bits=cfg.security_bits, num_challenges=cfg.num_challenges,
        zero_knowledge=cfg.zero_knowledge,
        max_quotient_degree_factor=cfg.max_quotient_degree_factor,
        fri_config=fri_config_from_jax(cfg.fri_config), hasher=cfg.hasher)


def _schedule_from_jax(sched, luts: list) -> WitnessSchedule:
    """The port's WitnessSchedule with the JAX one's leveled plan: written
    by the checkpoint codec (which reads the same fields from either
    package's schedule) and read back, custom generator functions rebuilt
    from the port's registry by name."""
    buf = Buffer()
    write_schedule(buf, sched)
    return read_schedule(Buffer(buf.bytes()), luts)


def circuit_data_from_jax(data, device=None) -> CircuitData:
    """The port's CircuitData for a circuit the JAX package built: host
    arrays are copied, gates rebuilt from their ids, and constants + sigmas
    re-committed on ``device`` (None means CUDA).  Raises if the re-commit's
    Merkle cap differs from the JAX circuit's."""
    device = resolve_device(device)
    jc = data.common
    config = circuit_config_from_jax(jc.config)
    fp = jc.fri_params
    common = CommonCircuitData(
        config=config,
        fri_params=FriParams(config.fri_config, fp.hiding, fp.degree_bits,
                             tuple(fp.reduction_arity_bits)),
        gates=[gate_from_id(g.id()) for g in jc.gates],
        selectors_info=SelectorsInfo(
            list(jc.selectors_info.selector_indices),
            [range(r.start, r.stop) for r in jc.selectors_info.groups]),
        quotient_degree_factor=jc.quotient_degree_factor,
        num_gate_constraints=jc.num_gate_constraints,
        num_constants=jc.num_constants,
        num_public_inputs=jc.num_public_inputs,
        k_is=np.asarray(jc.k_is, np.uint64).copy(),
        num_partial_products=jc.num_partial_products,
        num_lookup_polys=jc.num_lookup_polys,
        num_lookup_selectors=jc.num_lookup_selectors,
        luts=list(jc.luts))

    jp = data.prover_only
    jcs = jp.constants_sigmas_commitment
    commitment = PolynomialBatch.from_coeffs(
        gf_from_jax(jcs.polynomials, device), jcs.rate_bits, False,
        config.fri_config.cap_height, hasher=config.hasher)
    cap_data = np.asarray(data.verifier_only.constants_sigmas_cap.data).copy()
    cap = (BytesMerkleCap(cap_data) if config.hasher == "keccak"
           else MerkleCap(cap_data.astype(np.uint64)))
    # Poseidon digests are u64 felts, keccak digests raw bytes
    digest_dtype = np.uint8 if config.hasher == "keccak" else np.uint64
    if commitment.merkle_tree.cap != cap:
        raise ValueError("re-committed constants/sigmas cap differs from the "
                         "JAX circuit's")
    prover_only = ProverOnlyCircuitData(
        schedule=_schedule_from_jax(jp.schedule, common.luts),
        constants_sigmas_commitment=commitment,
        sigmas=np.asarray(jp.sigmas, np.uint64).copy(),
        subgroup=np.asarray(jp.subgroup, np.uint64).copy(),
        public_inputs=list(jp.public_inputs),
        circuit_digest=np.asarray(jp.circuit_digest, digest_dtype).copy(),
        lookup_rows=list(jp.lookup_rows or []))
    verifier_only = VerifierOnlyCircuitData(
        constants_sigmas_cap=cap,
        circuit_digest=np.asarray(data.verifier_only.circuit_digest,
                                  digest_dtype).copy())
    return CircuitData(prover_only, verifier_only, common)
