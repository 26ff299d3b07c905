"""Staged per-table recursive verification of multi-table proofs.

Twin of reference evm/src/recursive_verifier.rs:265
(`recursive_stark_circuit` / `StarkWrapperCircuit`) + the root-circuit
chaining of evm/src/fixed_recursive_verifier.rs:399: instead of one
monolithic circuit replaying the whole shared transcript
(stark/multi_recursive.py), each table's STARK proof is verified by its
OWN wrapper circuit, seeded from the challenger state at that table's
transcript boundary.  The wrapper exposes as public inputs

    trace_cap | ctl_zs_last | ctl challenges | state before | state after

and a root circuit ties the wrappers together: it re-derives the CTL
challenges from the public trace caps, connects each wrapper's claimed
challenges and chains state_after(i) == state_before(i+1), runs the
cross-table product checks on the public ctl_zs_last values, and
verifies every wrapper proof.  Wrapper proofs are independent, so the
expensive per-table shrinking can run in parallel across hosts/chips.

Port change: the wrappers and the root are built, and proved, on the
``device`` the caller passes (CUDA unless it names another).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..iop.challenger import Challenger, RecursiveChallenger
from ..plonk.builder import CircuitBuilder
from ..plonk.witness import PartialWitness
from ..recursion.recursive_verifier import add_virtual_proof_with_pis
from .config import StarkConfig
from .ctl import GrandProductChallenge, num_ctl_zs
from .multi import MultiProof
from .multi_recursive import (add_virtual_multi_stark_proof,
                              set_multi_stark_proof_target,
                              verify_cross_table_lookups_circuit,
                              verify_table_circuit, wrap_ctl_challenges)

SPONGE_WIDTH = 12


@dataclass
class WrapperPublicInputs:
    """Slices of a wrapper proof's public inputs
    (evm/src/recursive_verifier.rs:54 PublicInputs)."""

    trace_cap: list        # cap_elts x 4
    ctl_zs_last: list
    ctl_challenges: list   # (beta, gamma) pairs
    state_before: list     # 12
    state_after: list      # 12

    @staticmethod
    def from_vec(v: list, config: StarkConfig, num_ctl: int):
        nelts = config.fri_config.num_cap_elements()
        it = iter(v)
        take = lambda n: [next(it) for _ in range(n)]
        cap = [take(4) for _ in range(nelts)]
        zs_last = take(num_ctl)
        chals = [(next(it), next(it))
                 for _ in range(config.num_challenges)]
        before = take(SPONGE_WIDTH)
        after = take(SPONGE_WIDTH)
        assert next(it, None) is None, "wrapper public-input length"
        return WrapperPublicInputs(cap, zs_last, chals, before, after)


class StarkWrapperCircuit:
    """One table's recursive verifier, seeded from an injected
    challenger state (recursive_verifier.rs:265)."""

    def __init__(self, stark, table: int, ctls: list,
                 stark_config: StarkConfig, degree_bits: int,
                 circuit_config, device=None):
        self.stark = stark
        self.table = table
        self.stark_config = stark_config
        self.degree_bits = degree_bits
        num_ctl = num_ctl_zs(ctls, table, stark_config.num_challenges)

        b = CircuitBuilder(circuit_config)
        pt = add_virtual_multi_stark_proof(b, stark, stark_config,
                                           degree_bits, num_ctl)
        # public inputs, in WrapperPublicInputs order
        for h in pt.trace_cap:
            b.register_public_inputs(list(h))
        b.register_public_inputs(list(pt.openings.ctl_zs_last))
        ctl_raw = []
        for _ in range(stark_config.num_challenges):
            beta = b.add_virtual_target()
            gamma = b.add_virtual_target()
            b.register_public_input(beta)
            b.register_public_input(gamma)
            ctl_raw.append(GrandProductChallenge(beta, gamma))
        init_state = [b.add_virtual_target() for _ in range(SPONGE_WIDTH)]
        b.register_public_inputs(init_state)

        ch = RecursiveChallenger.from_state(b, init_state)
        verify_table_circuit(b, ch, stark, table, ctls,
                             wrap_ctl_challenges(b, ctl_raw), pt,
                             stark_config, degree_bits)
        final_state = ch.compact()
        b.register_public_inputs(list(final_state))

        self.data = b.build(device)
        self.proof_target = pt
        self.ctl_challenge_targets = ctl_raw
        self.init_state_targets = init_state

    def prove(self, table_proof, ctl_challenges: list):
        """table_proof: a MultiTableStarkProof carrying its
        init_challenger_state."""
        pw = PartialWitness()
        set_multi_stark_proof_target(pw, self.proof_target, table_proof)
        for t, c in zip(self.ctl_challenge_targets, ctl_challenges):
            pw.set_target(t.beta, int(c.beta))
            pw.set_target(t.gamma, int(c.gamma))
        assert table_proof.init_challenger_state is not None, \
            "proof was generated without boundary challenger states"
        for t, v in zip(self.init_state_targets,
                        np.asarray(table_proof.init_challenger_state,
                                   np.uint64)):
            pw.set_target(t, int(v))
        proof = self.data.prove(pw)
        self.data.verify(proof)
        return proof


class StagedRootCircuit:
    """Combines the wrapper proofs (fixed_recursive_verifier.rs:399
    create_root_circuit, minus the per-size shrinking chains)."""

    def __init__(self, wrappers: list, ctls: list,
                 stark_config: StarkConfig, circuit_config, device=None):
        from ..recursion.recursive_verifier import verify_proof_circuit
        from ..zkevm.aggregation import constant_verifier_data

        self.wrappers = wrappers
        b = CircuitBuilder(circuit_config)
        self.proof_targets = [
            add_virtual_proof_with_pis(b, w.data.common) for w in wrappers]
        num_ctls = [len(w.proof_target.openings.ctl_zs_last)
                    for w in wrappers]
        pis = [WrapperPublicInputs.from_vec(pt.public_inputs, stark_config,
                                            n)
               for pt, n in zip(self.proof_targets, num_ctls)]

        # re-derive the CTL challenges from the public trace caps
        ch = RecursiveChallenger(b)
        for pi in pis:
            for h in pi.trace_cap:
                ch.observe_elements(h)
        from .ctl import get_grand_product_challenge_set
        raw = get_grand_product_challenge_set(ch, stark_config.num_challenges)
        for pi in pis:
            for (beta, gamma), c in zip(pi.ctl_challenges, raw):
                b.connect(beta, c.beta)
                b.connect(gamma, c.gamma)
        # challenger-state chaining across tables
        state = ch.compact()
        for s, t in zip(state, pis[0].state_before):
            b.connect(s, t)
        for i in range(1, len(pis)):
            for s, t in zip(pis[i - 1].state_after, pis[i].state_before):
                b.connect(s, t)
        # cross-table products on the public ctl_zs_last values
        verify_cross_table_lookups_circuit(
            b, ctls, [pi.ctl_zs_last for pi in pis],
            stark_config.num_challenges)
        # verify every wrapper proof against its baked-in key
        for w, pt in zip(wrappers, self.proof_targets):
            vdt = constant_verifier_data(b, w.data.verifier_only)
            verify_proof_circuit(b, pt, vdt, w.data.common)
        self.data = b.build(device)

    def prove(self, wrapper_proofs: list):
        from ..recursion import set_proof_with_pis_target
        pw = PartialWitness()
        for pt, p in zip(self.proof_targets, wrapper_proofs):
            set_proof_with_pis_target(pw, pt, p)
        proof = self.data.prove(pw)
        self.data.verify(proof)
        return proof


def prove_staged(starks: list, ctls: list, multi_proof: MultiProof,
                 stark_config: StarkConfig, circuit_config,
                 device=None) -> tuple:
    """Build the wrappers + root on ``device`` and produce the combined
    proof.  The per-table wrapper proofs are independent
    (parallelisable)."""
    # re-derive the CTL challenges the proof transcript used
    challenger = Challenger()
    for p in multi_proof.stark_proofs:
        challenger.observe_cap(p.trace_cap)
    from .ctl import get_grand_product_challenge_set
    ctl_challenges = get_grand_product_challenge_set(
        challenger, stark_config.num_challenges)

    wrappers = [
        StarkWrapperCircuit(stark, i, ctls, stark_config,
                            multi_proof.stark_proofs[i].degree_bits,
                            circuit_config, device)
        for i, stark in enumerate(starks)]
    wrapper_proofs = [
        w.prove(p, ctl_challenges)
        for w, p in zip(wrappers, multi_proof.stark_proofs)]
    root = StagedRootCircuit(wrappers, ctls, stark_config, circuit_config,
                             device)
    root_proof = root.prove(wrapper_proofs)
    return root, root_proof
