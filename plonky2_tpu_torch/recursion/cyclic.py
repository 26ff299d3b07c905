"""Cyclic recursion (IVC): a circuit that verifies proofs of itself.

Twin of reference recursion/cyclic_recursion.rs:100-178.  The circuit's own
verifier key rides in its public inputs (`add_verifier_data_public_inputs`);
each step checks the inner proof's claimed key equals its own, and the
out-of-circuit verifier pins the key with `check_cyclic_proof_verifier_data`.
Port change: the circuits built only to fix a shape, and the dummy circuit
of the ``_or_dummy`` form, are built on the ``device`` the caller passes.
"""

from __future__ import annotations

import numpy as np

from ..plonk.builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from .conditional import conditionally_verify_proof
from .dummy import dummy_proof_and_vk_targets
from .recursive_verifier import (VerifierCircuitTarget,
                                 add_virtual_proof_with_pis,
                                 add_virtual_verifier_data,
                                 verify_proof_circuit)


def _verifier_data_from_pi_slice(pis, cap_len: int) -> VerifierCircuitTarget:
    """[..., digest (4), cap (4*cap_len)] at the END of the public inputs
    (cyclic_recursion.rs:63)."""
    n = len(pis)
    assert n >= 4 + 4 * cap_len, "not enough public inputs for a verifier key"
    cap = [list(pis[n - 4 * (cap_len - i):n - 4 * (cap_len - i) + 4])
           for i in range(cap_len)]
    digest = list(pis[n - 4 - 4 * cap_len:n - 4 * cap_len])
    return VerifierCircuitTarget(constants_sigmas_cap=cap,
                                 circuit_digest=digest)


def conditionally_verify_cyclic_proof(b: CircuitBuilder, condition,
                                      cyclic_proof_with_pis,
                                      other_proof_with_pis,
                                      other_verifier_data,
                                      common_data) -> None:
    """Verify a proof of THIS circuit if condition, else `other` proof
    (cyclic_recursion.rs:100).  `add_verifier_data_public_inputs` must have
    been called, and no further public inputs may be registered after this."""
    verifier_data = getattr(b, "verifier_data_public_input", None)
    assert verifier_data is not None, \
        "call add_verifier_data_public_inputs before cyclic recursion"

    cap_len = common_data.config.fri_config.num_cap_elements()
    inner_pis_vd = _verifier_data_from_pi_slice(
        cyclic_proof_with_pis.public_inputs, cap_len)
    # every proof in the cycle must carry the same verifier key
    b.connect_hashes(inner_pis_vd.circuit_digest, verifier_data.circuit_digest)
    for h0, h1 in zip(inner_pis_vd.constants_sigmas_cap,
                      verifier_data.constants_sigmas_cap):
        b.connect_hashes(h0, h1)

    conditionally_verify_proof(b, condition, cyclic_proof_with_pis,
                               verifier_data, other_proof_with_pis,
                               other_verifier_data, common_data)

    # make sure our gate set covers everything common_data promises
    for g in common_data.gates:
        b.add_gate_to_gate_set(g)


def conditionally_verify_cyclic_proof_or_dummy(b: CircuitBuilder, condition,
                                               cyclic_proof_with_pis,
                                               common_data,
                                               device=None) -> None:
    dummy_pt, dummy_vdt = dummy_proof_and_vk_targets(b, common_data, device)
    conditionally_verify_cyclic_proof(b, condition, cyclic_proof_with_pis,
                                      dummy_pt, dummy_vdt, common_data)


def check_cyclic_proof_verifier_data(proof_with_pis, verifier_data,
                                     common_data) -> None:
    """Out-of-circuit check that the proof's claimed verifier key matches
    the real one (cyclic_recursion.rs:178)."""
    cap_len = common_data.config.fri_config.num_cap_elements()
    pis = np.asarray(proof_with_pis.public_inputs, dtype=np.uint64)
    n = len(pis)
    digest = pis[n - 4 - 4 * cap_len:n - 4 * cap_len]
    assert np.array_equal(digest, np.asarray(verifier_data.circuit_digest)), \
        "cyclic proof claims a different circuit digest"
    cap = pis[n - 4 * cap_len:].reshape(cap_len, 4)
    assert np.array_equal(cap, verifier_data.constants_sigmas_cap.data), \
        "cyclic proof claims a different constants/sigmas cap"


def common_data_for_recursion(config: CircuitConfig, num_extra_pis: int,
                              min_degree_bits: int = 12, device=None):
    """A CommonCircuitData shape that can describe a circuit verifying proofs
    of that same shape (the fixed point used by cyclic tests;
    cyclic_recursion.rs tests common_data_for_recursion).  Its three probe
    circuits are built on ``device``."""
    # level 0: the empty circuit
    b = CircuitBuilder(config)
    data = b.build(device)
    # two wrapping levels so the shape stabilises
    for _ in range(2):
        b = CircuitBuilder(config)
        pt = add_virtual_proof_with_pis(b, data.common)
        vdt = add_virtual_verifier_data(b, config.fri_config.cap_height)
        verify_proof_circuit(b, pt, vdt, data.common)
        data = b.build(device)

    # final shape: one verifier plus padding to the requested degree, leaving
    # exactly the headroom for the rows build() itself appends
    b = CircuitBuilder(config)
    pt = add_virtual_proof_with_pis(b, data.common)
    vdt = add_virtual_verifier_data(b, config.fri_config.cap_height)
    verify_proof_circuit(b, pt, vdt, data.common)
    # the shape's PI count is 0 but the real circuit hashes its PIs; reserve
    # for the larger of the two so both land on the same power of two
    num_pis = num_extra_pis + 4 + 4 * config.fri_config.num_cap_elements()
    _pad_leaving_build_overhead(b, 1 << min_degree_bits, num_pis)
    data = b.build(device)
    common = data.common
    assert common.degree_bits() == min_degree_bits, \
        f"recursion shape needs min_degree_bits >= {common.degree_bits()}"
    # the cyclic circuit's public inputs: user PIs + verifier key
    common.num_public_inputs = num_pis
    return common


def _build_overhead(b: CircuitBuilder, num_pis: int) -> int:
    """Rows build() will append: PI-hash Poseidon rows, the PublicInputGate,
    and ConstantGates for still-unplaced deduped constants."""
    pi_rows = -(-num_pis // 8) if num_pis else 0
    pending_consts = max(0, len(b.constants_to_targets)
                         - len(b.constant_generators))
    const_rows = -(-pending_consts // max(b.config.num_constants, 1))
    return pi_rows + 1 + const_rows + 8  # margin for hash-chain constants


def _pad_leaving_build_overhead(b: CircuitBuilder, target: int,
                                num_pis: int) -> None:
    from ..plonk.gates.simple import NoopGate
    overhead = _build_overhead(b, num_pis)
    assert b.num_gates() + overhead <= target, \
        f"circuit too large for degree target {target}"
    while b.num_gates() + overhead < target:
        b.add_gate(NoopGate(), [])


def pad_to_common_degree(b: CircuitBuilder, common) -> None:
    """Pad a cyclic circuit so build() lands exactly on common.degree()
    (the reference tests' `while builder.num_gates() < 1 << 12` loop)."""
    _pad_leaving_build_overhead(b, common.degree(), common.num_public_inputs)
