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

import re

import numpy as np

from .field.goldilocks import GF
from .fri.config import FriConfig, FriParams, FriReductionStrategy
from .fri.oracle import PolynomialBatch
from .hash.keccak_tree import BytesMerkleCap
from .hash.merkle import MerkleCap
from .plonk import targets as tg
from .plonk.circuit_data import (CircuitData, CommonCircuitData,
                                 ProverOnlyCircuitData, SelectorsInfo,
                                 VerifierOnlyCircuitData)
from .plonk.config import CircuitConfig
from .plonk.gates.base import GeneratorSpec
from .plonk.generators import build_custom_fn
from .plonk.witness import WitnessSchedule, _Group
from .stark.config import StarkConfig
from .utils.cuda import resolve_device


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


def gate_from_id(gate_id: str):
    """Rebuild a port gate from its id() string (the registry twin of
    impl_gate_serializer!, gate_serialization.rs:48)."""
    from .plonk.gates.arithmetic import ArithmeticGate
    from .plonk.gates.ext_gates import (ArithmeticExtensionGate,
                                        MulExtensionGate, PoseidonMdsGate,
                                        ReducingExtensionGate, ReducingGate)
    from .plonk.gates.interpolation import CosetInterpolationGate
    from .plonk.gates.lookup import LookupGate, LookupTableGate
    from .plonk.gates.misc import (BaseSumGate, ExponentiationGate,
                                   RandomAccessGate)
    from .plonk.gates.poseidon_gate import PoseidonGate
    from .plonk.gates.simple import ConstantGate, NoopGate, PublicInputGate

    ints = [int(x) for x in re.findall(r"-?\d+", gate_id)]
    simple = {"PoseidonMdsGate": PoseidonMdsGate, "PoseidonGate": PoseidonGate,
              "NoopGate": NoopGate, "PublicInputGate": PublicInputGate}
    one_int = {"ArithmeticGate": ArithmeticGate,
               "ArithmeticExtensionGate": ArithmeticExtensionGate,
               "MulExtensionGate": MulExtensionGate,
               "ReducingExtensionGate": ReducingExtensionGate,
               "ReducingGate": ReducingGate, "ConstantGate": ConstantGate,
               "ExponentiationGate": ExponentiationGate}
    name = re.match(r"[A-Za-z]+", gate_id).group(0)
    if name in simple:
        return simple[name]()
    if name in one_int:
        return one_int[name](ints[0])
    if name == "BaseSumGate":
        return BaseSumGate(ints[0], ints[1])
    if name == "RandomAccessGate":
        return RandomAccessGate(ints[0], ints[1], ints[2])
    if name == "CosetInterpolationGate":
        gate = CosetInterpolationGate(ints[0], 1 << ints[0])
        gate._degree = ints[1]
        return gate
    if name == "LookupTableGate":
        return LookupTableGate(ints[0], ints[1], ints[2])
    if name == "LookupGate":
        return LookupGate(ints[0], ints[1])
    raise ValueError(f"unknown gate id: {gate_id}")


def _schedule_from_jax(sched, luts: list) -> WitnessSchedule:
    """The port's WitnessSchedule with the JAX one's leveled plan (the same
    fields its checkpoint reader restores); custom generator functions are
    rebuilt from the port's registry by name."""
    out = object.__new__(WitnessSchedule)
    out.num_rows = sched.num_rows
    out.num_wires = sched.num_wires
    out.num_virtual = sched.num_virtual
    out.total = sched.total
    out.rng_seed = sched.rng_seed
    out.parents = np.asarray(sched.parents, np.int64).copy()

    def dense(t: int) -> int:
        if tg.is_wire(t):
            return tg.wire_row(t) * out.num_wires + tg.wire_column(t)
        return out.num_rows * out.num_wires + tg.virtual_index(t)

    def custom_fn(name, params):
        if name is None:
            raise ValueError("a custom generator without a registry name "
                             "cannot be carried across")
        return build_custom_fn(name, tuple(params), luts)

    out._dense = dense
    out.levels = []
    for groups in sched.levels:
        level = []
        for g in groups:
            fns = ([custom_fn(nm, g.params[i]) for i, nm in enumerate(g.names)]
                   if g.kind == "custom" else None)
            params = (np.asarray(g.params).copy()
                      if isinstance(g.params, np.ndarray) else list(g.params))
            level.append(_Group(g.kind, np.asarray(g.dep_reps).copy(),
                                np.asarray(g.out_reps).copy(), params, fns,
                                None if g.names is None else list(g.names)))
        out.levels.append(level)
    out._residual_specs = [
        (GeneratorSpec(spec.kind, list(spec.deps), list(spec.outs),
                       tuple(spec.params),
                       custom_fn(spec.name, spec.params)
                       if spec.kind == "custom" else None, spec.name),
         list(dreps), list(oreps))
        for spec, dreps, oreps in sched._residual_specs]
    out.residual = list(sched.residual)
    out._residual_out_reps = set(sched._residual_out_reps)
    return out


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
