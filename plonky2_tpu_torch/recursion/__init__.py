"""Recursion layer: in-circuit proof verification, conditional and cyclic
recursion, dummy circuits (reference recursion/).

Host code, as in the JAX package: a recursive verifier only adds gates to a
CircuitBuilder.  Every circuit these modules build and prove themselves
(dummy circuits, the shape probes of ``common_data_for_recursion``) is
built on the ``device`` the caller passes (CUDA unless it names another),
and its proofs run there.
"""

from .conditional import (conditionally_verify_proof,
                          conditionally_verify_proof_or_dummy)
from .cyclic import (check_cyclic_proof_verifier_data,
                     common_data_for_recursion,
                     conditionally_verify_cyclic_proof,
                     conditionally_verify_cyclic_proof_or_dummy)
from .dummy import cyclic_base_proof, dummy_circuit, dummy_proof
from .recursive_verifier import (ProofWithPublicInputsTarget, ProofTarget,
                                 VerifierCircuitTarget, add_virtual_proof_with_pis,
                                 add_virtual_verifier_data, set_proof_with_pis_target,
                                 set_verifier_data_target, verify_proof_circuit)

__all__ = [
    "ProofWithPublicInputsTarget", "ProofTarget", "VerifierCircuitTarget",
    "add_virtual_proof_with_pis", "add_virtual_verifier_data",
    "set_proof_with_pis_target", "set_verifier_data_target",
    "verify_proof_circuit", "conditionally_verify_proof",
    "conditionally_verify_proof_or_dummy", "conditionally_verify_cyclic_proof",
    "conditionally_verify_cyclic_proof_or_dummy",
    "check_cyclic_proof_verifier_data", "common_data_for_recursion",
    "cyclic_base_proof", "dummy_circuit", "dummy_proof",
]
