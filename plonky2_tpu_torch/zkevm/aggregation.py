"""Staged recursive aggregation for multi-table STARK proofs (twin of
reference evm/src/fixed_recursive_verifier.rs AllRecursiveCircuits).

Three plonk circuits:

- **root** — verifies a whole multi-table CTL proof in-circuit
  (stark/multi_recursive.py), producing one fixed-shape plonk proof per
  "transaction" (fixed_recursive_verifier.rs:399 create_root_circuit;
  the reference additionally shrinks each table separately first —
  that staged split is a parallelism optimisation over the same
  machinery).
- **aggregation** — binary-tree combiner: verifies two children, each
  either another aggregation proof (cyclic, via the verifier key in the
  public inputs) or a root proof (`:508 create_aggregation_circuit`).
- **block** — chains blocks: cyclically verifies the previous block
  proof (or a dummy for the first block) plus one aggregation root
  proof (`:551 create_block_circuit`).

The fixed point: the aggregation circuit verifies proofs of its *own*
shape, and root proofs must share that shape.  Both circuits are built
with the union of their gate sets and padded to a common degree until
their `CommonCircuitData` agree (the reference gets this for free from
`add_common_recursion_gates` + explicit padding).

Port change: the circuits are built on the ``device`` the caller passes
(CUDA unless it names another) and prove there; a checkpoint
(``to_bytes``) is read back onto a device of the caller's choosing
(``from_bytes(..., device=)``), which re-uploads the constants and sigmas
commitment (utils/serialization.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..plonk.builder import CircuitBuilder
from ..plonk.witness import PartialWitness
from ..recursion import (add_virtual_proof_with_pis,
                         set_proof_with_pis_target,
                         set_verifier_data_target, verify_proof_circuit)
from ..recursion.cyclic import (check_cyclic_proof_verifier_data,
                                conditionally_verify_cyclic_proof,
                                conditionally_verify_cyclic_proof_or_dummy,
                                pad_to_common_degree)
from ..recursion.dummy import common_data_equal, cyclic_base_proof
from ..recursion.recursive_verifier import VerifierCircuitTarget
from ..utils.cuda import resolve_device
from ..stark.ctl import num_ctl_zs
from ..stark.multi_recursive import (add_virtual_multi_stark_proof,
                                     set_multi_proof_targets,
                                     verify_multi_proof_circuit)


def constant_verifier_data(b: CircuitBuilder,
                           verifier_only) -> VerifierCircuitTarget:
    """Bake a verifier key into the circuit as constants
    (circuit_builder.rs constant_verifier_data)."""
    cap = [[b.constant(int(x)) for x in h]
           for h in np.asarray(verifier_only.constants_sigmas_cap.data,
                               np.uint64)]
    digest = [b.constant(int(x))
              for x in np.asarray(verifier_only.circuit_digest, np.uint64)]
    return VerifierCircuitTarget(constants_sigmas_cap=cap,
                                 circuit_digest=digest)


@dataclass
class AggChildTarget:
    """(fixed_recursive_verifier.rs AggregationChildTarget)"""

    is_agg: int
    agg_proof: object
    root_proof: object


class AllRecursiveCircuits:
    """(fixed_recursive_verifier.rs:56)"""

    def __init__(self, starks, ctls, stark_config, degree_bits_per_table,
                 circuit_config, target_degree_bits: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.starks = starks
        self.ctls = ctls
        self.stark_config = stark_config
        self.degree_bits = degree_bits_per_table
        self.config = circuit_config

        # pass 1: find the natural sizes of both circuits
        root_probe = self._build_root(pad_common=None)
        agg_probe = self._build_agg(root_probe.common, pad_common=None,
                                    root_vk=root_probe.verifier_only)
        bits = max(root_probe.common.degree_bits(),
                   agg_probe.common.degree_bits())
        if target_degree_bits is not None:
            assert target_degree_bits >= bits
            bits = target_degree_bits
        # pass 2: rebuild both with the union gate set at the common size
        # (build() sorts the gate set canonically, so equal sets give
        # equal gate lists)
        union = {g.id(): g for g in root_probe.common.gates}
        for g in agg_probe.common.gates:
            union.setdefault(g.id(), g)
        union = list(union.values())
        shape = agg_probe.common
        shape.num_public_inputs = root_probe.common.num_public_inputs
        self.root = self._build_root(pad_common=(union, bits, shape))
        self.aggregation = self._build_agg(
            self.root.common, pad_common=(union, bits, shape),
            root_vk=self.root.verifier_only)
        assert common_data_equal(self.root.common, self.aggregation.common), \
            "root/aggregation circuits did not converge to one shape"
        self.block = self._build_block()

    # ------------------------------------------------------------------
    def _pad(self, b: CircuitBuilder, pad_common) -> None:
        if pad_common is None:
            return
        from ..recursion.cyclic import _pad_leaving_build_overhead
        union, bits, shape = pad_common
        for g in union:
            b.add_gate_to_gate_set(g)
        _pad_leaving_build_overhead(b, 1 << bits, shape.num_public_inputs)

    def _build_root(self, pad_common):
        """Root circuit: cyclic-vk public inputs (to match the
        aggregation shape) + full in-circuit multi-proof verification."""
        b = CircuitBuilder(self.config)
        b.add_verifier_data_public_inputs()
        pts = [add_virtual_multi_stark_proof(
            b, stark, self.stark_config, dbits,
            num_ctl_zs(self.ctls, i, self.stark_config.num_challenges))
            for i, (stark, dbits) in enumerate(zip(self.starks,
                                                   self.degree_bits))]
        verify_multi_proof_circuit(b, self.starks, self.ctls, pts,
                                   self.stark_config, self.degree_bits)
        self._pad(b, pad_common)
        data = b.build(self.device)
        data.root_pts = pts
        data.verifier_data_pi = b.verifier_data_public_input
        return data

    def _build_agg(self, child_common, pad_common, root_vk):
        """Aggregation circuit: two root-or-agg children."""
        b = CircuitBuilder(self.config)
        b.add_verifier_data_public_inputs()
        root_vdt = constant_verifier_data(b, root_vk)
        children = []
        for _ in range(2):
            is_agg = b.add_virtual_target()
            agg_pt = add_virtual_proof_with_pis(b, child_common)
            root_pt = add_virtual_proof_with_pis(b, child_common)
            conditionally_verify_cyclic_proof(
                b, is_agg, agg_pt, root_pt, root_vdt, child_common)
            children.append(AggChildTarget(is_agg, agg_pt, root_pt))
        self._pad(b, pad_common)
        data = b.build(self.device)
        data.children = children
        data.verifier_data_pi = b.verifier_data_public_input
        return data

    def _build_block(self):
        """Block circuit: previous block (cyclic or dummy) + one
        aggregation root proof."""
        b = CircuitBuilder(self.config)
        b.add_verifier_data_public_inputs()
        has_parent = b.add_virtual_target()
        common = self.aggregation.common
        parent_pt = add_virtual_proof_with_pis(b, common)
        agg_pt = add_virtual_proof_with_pis(b, common)
        conditionally_verify_cyclic_proof_or_dummy(b, has_parent, parent_pt,
                                                   common, self.device)
        agg_vdt = constant_verifier_data(b, self.aggregation.verifier_only)
        verify_proof_circuit(b, agg_pt, agg_vdt, common)
        pad_to_common_degree(b, common)
        data = b.build(self.device)
        assert common_data_equal(data.common, common), \
            "block circuit diverged from the aggregation shape"
        data.has_parent = has_parent
        data.parent_pt = parent_pt
        data.agg_pt = agg_pt
        data.verifier_data_pi = b.verifier_data_public_input
        return data

    # ------------------------------------------------------------------
    # checkpoint (fixed_recursive_verifier.rs:95 to_buffer / :111 from_buffer)

    _EXTRAS = (("root", ("root_pts", "verifier_data_pi")),
               ("aggregation", ("children", "verifier_data_pi")),
               ("block", ("has_parent", "parent_pt", "agg_pt",
                          "verifier_data_pi")))

    def to_bytes(self) -> bytes:
        """Serialize all three circuits with their attached proof targets
        so the expensive double-pass build runs once per deployment."""
        from ..utils.serialization import (Buffer, _write_literal,
                                           circuit_data_to_bytes,
                                           encode_target_tree)
        buf = Buffer()
        _write_literal(buf, tuple(int(b) for b in self.degree_bits))
        for name, extras in self._EXTRAS:
            data = getattr(self, name)
            blob = circuit_data_to_bytes(data)
            buf.write_usize(len(blob))
            buf.data += blob
            _write_literal(buf, encode_target_tree(
                tuple(getattr(data, e) for e in extras)))
        return buf.bytes()

    @classmethod
    def from_bytes(cls, raw: bytes, starks, ctls, stark_config, device=None):
        """Restore a checkpoint onto ``device``; the stark set/CTLs/config
        are cheap to construct and passed in (the reference's from_buffer
        likewise rebuilds around a Default AllStark)."""
        from ..utils.serialization import (Buffer, _read_literal,
                                           circuit_data_from_bytes,
                                           decode_target_tree)
        buf = Buffer(raw)
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.starks = starks
        self.ctls = ctls
        self.stark_config = stark_config
        self.degree_bits = list(_read_literal(buf))
        for name, extras in cls._EXTRAS:
            data = circuit_data_from_bytes(buf._take(buf.read_usize()),
                                           self.device)
            for e, v in zip(extras, decode_target_tree(_read_literal(buf))):
                setattr(data, e, v)
            setattr(self, name, data)
        self.config = self.root.common.config
        return self

    # ------------------------------------------------------------------
    # proving (fixed_recursive_verifier.rs:590,630,667)

    def prove_root(self, multi_proof):
        pw = PartialWitness()
        set_multi_proof_targets(pw, self.root.root_pts, multi_proof)
        # root proofs carry the AGGREGATION circuit's key in their cyclic-vk
        # public inputs: an aggregation child's cyclic check reads the vk
        # from whatever proof fills the agg slot, which for a leaf is this
        # root proof (fixed_recursive_verifier.rs:590 prove_root)
        set_verifier_data_target(pw, self.root.verifier_data_pi,
                                 self.aggregation.verifier_only)
        proof = self.root.prove(pw)
        self.root.verify(proof)
        return proof

    def prove_aggregation(self, lhs, lhs_is_agg: bool, rhs,
                          rhs_is_agg: bool):
        pw = PartialWitness()
        for child, proof, is_agg in ((self.aggregation.children[0], lhs,
                                      lhs_is_agg),
                                     (self.aggregation.children[1], rhs,
                                      rhs_is_agg)):
            pw.set_target(child.is_agg, int(is_agg))
            set_proof_with_pis_target(
                pw, child.agg_proof if is_agg else child.root_proof, proof)
            # the unselected slot still needs a syntactically-valid proof
            set_proof_with_pis_target(
                pw, child.root_proof if is_agg else child.agg_proof, proof)
        set_verifier_data_target(pw, self.aggregation.verifier_data_pi,
                                 self.aggregation.verifier_only)
        proof = self.aggregation.prove(pw)
        check_cyclic_proof_verifier_data(proof, self.aggregation.verifier_only,
                                         self.aggregation.common)
        self.aggregation.verify(proof)
        return proof

    def prove_block(self, parent_block_proof, agg_proof):
        pw = PartialWitness()
        has_parent = parent_block_proof is not None
        pw.set_target(self.block.has_parent, int(has_parent))
        if not has_parent:
            parent_block_proof = cyclic_base_proof(
                self.block.common, self.block.verifier_only,
                device=self.device)
        set_proof_with_pis_target(pw, self.block.parent_pt,
                                  parent_block_proof)
        set_proof_with_pis_target(pw, self.block.agg_pt, agg_proof)
        set_verifier_data_target(pw, self.block.verifier_data_pi,
                                 self.block.verifier_only)
        proof = self.block.prove(pw)
        check_cyclic_proof_verifier_data(proof, self.block.verifier_only,
                                         self.block.common)
        self.block.verify(proof)
        return proof
