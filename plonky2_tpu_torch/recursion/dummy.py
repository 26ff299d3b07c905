"""Dummy circuits & proofs for recursion base cases.

Twin of reference recursion/dummy_circuit.rs:33-146: `dummy_circuit` builds a
circuit whose CommonCircuitData matches a given shape; `dummy_proof` proves
it with (mostly) zero public inputs; `cyclic_base_proof` produces the padding
proof for the first step of an IVC chain, with the cyclic verifier key baked
into the right public-input slots.

Port change: the dummy circuit is built, and its proof made, on the
``device`` the caller passes (CUDA unless it names another); a build-time
dummy proof (``dummy_proof_and_vk_targets``) is made on the device of the
circuit being built around it.
"""

from __future__ import annotations

import numpy as np

from ..plonk.builder import CircuitBuilder
from ..plonk.gates.base import GeneratorSpec
from ..plonk.witness import PartialWitness
from .recursive_verifier import (add_virtual_proof_with_pis,
                                 add_virtual_verifier_data,
                                 fill_proof_with_pis_target)


def dummy_circuit(common_data, device=None) -> "CircuitData":
    """A circuit matching `common_data`'s shape (dummy_circuit.rs:86)."""
    assert not common_data.config.zero_knowledge, \
        "dummy circuits of zk shapes are not supported"
    degree = common_data.degree()
    num_pis = common_data.num_public_inputs
    # rows: PI-hash Poseidon rows + PublicInputGate + one ConstantGate
    num_noop = degree - (-(-num_pis // 8) if num_pis else 0) - 2

    b = CircuitBuilder(common_data.config)
    from ..plonk.gates.simple import NoopGate
    for _ in range(num_noop):
        b.add_gate(NoopGate(), [])
    for gate in common_data.gates:
        b.add_gate_to_gate_set(gate)
    pis = b.add_virtual_targets(num_pis)
    b.register_public_inputs(pis)
    data = b.build(device)
    assert common_data_equal(data.common, common_data), \
        "dummy circuit shape does not match the target CommonCircuitData"
    data.dummy_pi_targets = pis
    return data


def common_data_equal(a, b) -> bool:
    return (
        a.config == b.config
        and a.fri_params == b.fri_params
        and [g.id() for g in a.gates] == [g.id() for g in b.gates]
        and a.selectors_info.selector_indices == b.selectors_info.selector_indices
        and list(a.selectors_info.groups) == list(b.selectors_info.groups)
        and a.quotient_degree_factor == b.quotient_degree_factor
        and a.num_gate_constraints == b.num_gate_constraints
        and a.num_constants == b.num_constants
        and a.num_public_inputs == b.num_public_inputs
        and np.array_equal(a.k_is, b.k_is)
        and a.num_partial_products == b.num_partial_products
        and a.num_lookup_polys == b.num_lookup_polys
        and a.num_lookup_selectors == b.num_lookup_selectors
        and list(a.luts) == list(b.luts)
    )


def dummy_proof(circuit, nonzero_public_inputs: dict | None = None):
    """Prove the dummy circuit; unspecified public inputs default to zero
    (dummy_circuit.rs:67)."""
    pw = PartialWitness()
    nonzero_public_inputs = nonzero_public_inputs or {}
    for i, t in enumerate(circuit.dummy_pi_targets):
        pw.set_target(t, int(nonzero_public_inputs.get(i, 0)))
    return circuit.prove(pw)


def cyclic_base_proof(common_data, verifier_data,
                      nonzero_public_inputs: dict | None = None, device=None):
    """The base-case padding proof of an IVC chain: a dummy proof whose
    trailing public inputs carry the cyclic verifier key
    (dummy_circuit.rs:33)."""
    pis = dict(nonzero_public_inputs or {})
    cap_elements = common_data.config.fri_config.num_cap_elements()
    start = common_data.num_public_inputs - 4 - 4 * cap_elements
    for j in range(4):
        pis[start + j] = int(verifier_data.circuit_digest[j])
    for i in range(cap_elements):
        for j in range(4):
            pis[start + 4 + 4 * i + j] = int(verifier_data.constants_sigmas_cap.data[i][j])
    return dummy_proof(dummy_circuit(common_data, device), pis)


def dummy_proof_and_vk_targets(b, common_data, device=None):
    """Build-time dummy proof baked into the circuit as constant-valued
    targets (the reference's DummyProofGenerator, dummy_circuit.rs:121);
    the dummy circuit is built and proved on ``device``."""
    circuit = dummy_circuit(common_data, device)
    proof = dummy_proof(circuit)
    pt = add_virtual_proof_with_pis(b, common_data)
    vdt = add_virtual_verifier_data(b, common_data.config.fri_config.cap_height)

    def set_const(target, value):
        b.add_simple_generator(GeneratorSpec(
            "constant", deps=[], outs=[target], params=(int(value),)))

    fill_proof_with_pis_target(set_const, pt, proof)
    for t, v in zip(vdt.circuit_digest, circuit.verifier_only.circuit_digest):
        set_const(t, int(v))
    for ht, hv in zip(vdt.constants_sigmas_cap,
                      circuit.verifier_only.constants_sigmas_cap.data):
        for t, v in zip(ht, hv):
            set_const(t, int(v))
    return pt, vdt
