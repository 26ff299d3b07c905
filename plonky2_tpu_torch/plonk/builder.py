"""CircuitBuilder: gate placement, copy constraints, and circuit freezing.

Twin of reference plonk/circuit_builder.rs:149-1161.  Gate placement, slot
packing, constant dedup and copy constraints match the reference's
semantics; `build()` replaces the watch-list generator indexing with a
build-time leveled WitnessSchedule, and commits constants+sigmas through the
device PolynomialBatch on the device it is given (CUDA unless the caller
names another).
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..field.goldilocks import GF
from ..fri.oracle import PolynomialBatch
from ..hash.hashing import hash_no_pad_np
from ..hash.keccak import hash_n_to_bytes
from ..hash.keccak_tree import bytes_hash_to_felts
from ..utils.bits import log2_strict
from ..utils.cuda import resolve_device
from . import targets as tg
from .circuit_data import (CircuitData, CommonCircuitData, ProverOnlyCircuitData,
                           SelectorsInfo, VerifierOnlyCircuitData)
from .config import CircuitConfig
from .gates.arithmetic import ArithmeticGate
from .gates.base import GeneratorSpec
from .gates.lookup import (LookupGate, LookupTableGate,
                           lookup_output_generator, multiplicity_generator)
from .gates.poseidon_gate import WIDTH, PoseidonGate
from .gates.simple import ConstantGate, NoopGate, PublicInputGate
from .gadgets import BuilderGadgets
from .witness import WitnessSchedule

UNUSED_SELECTOR = (1 << 32) - 1

# Lookup challenge roles within each 4-delta group (circuit_builder.rs:66).
NUM_COINS_LOOKUP = 4
CHALLENGE_A, CHALLENGE_B, CHALLENGE_ALPHA, CHALLENGE_DELTA = 0, 1, 2, 3

# Lookup selector indices (gates/selectors.rs:34).
LOOKUP_TRANS_SRE, LOOKUP_TRANS_LDC, LOOKUP_INIT_SRE, LOOKUP_LAST_LDC, \
    LOOKUP_START_END = 0, 1, 2, 3, 4


class CircuitBuilder(BuilderGadgets):
    def __init__(self, config: CircuitConfig | None = None):
        self.config = config or CircuitConfig.standard_recursion_config()
        self.gate_instances: list = []  # (gate, constants list of ints)
        self.gate_set: dict = {}  # id -> gate (insertion-ordered registry)
        self.copy_constraints: list = []
        self.public_inputs: list = []
        self.virtual_target_index = 0
        self.constants_to_targets: dict = {}
        self.targets_to_constants: dict = {}
        self.generators: list = []  # user GeneratorSpecs
        self.constant_generators: list = []  # (row, constant_index, wire_index)
        self.current_slots: dict = {}  # (gate_id, params) -> (row, op)
        self.base_arithmetic_results: dict = {}
        self.suppressed_gate_generators: set = set()
        # lookups (gadgets/lookup.rs:48-77)
        self.luts: list = []  # of tuple of (u16 in, u16 out) pairs
        self.lut_to_lookups: list = []  # per LUT: [(looking_in, looking_out)]
        self.lookup_rows: list = []  # (last_lu_gate, last_lut_gate, first_lut_gate)
        # gate-count profiling (util/context_tree.rs)
        from ..utils.context_tree import ContextTracker
        self.context_tracker = ContextTracker()

    def context(self, name: str):
        """Profile gate counts of a construction scope (with_context! twin)."""
        return self.context_tracker.scope(name, self.num_gates)

    def print_context_tree(self, min_gates: int = 1) -> str:
        report = self.context_tracker.report(self.num_gates(), min_gates)
        print(report)
        return report

    # -- targets ------------------------------------------------------------
    def add_virtual_target(self) -> int:
        t = tg.virtual(self.virtual_target_index)
        self.virtual_target_index += 1
        return t

    def add_virtual_targets(self, n: int) -> list:
        return [self.add_virtual_target() for _ in range(n)]

    def register_public_input(self, t: int) -> None:
        self.public_inputs.append(t)

    def register_public_inputs(self, ts) -> None:
        for t in ts:
            self.register_public_input(t)

    def num_public_inputs(self) -> int:
        return len(self.public_inputs)

    def add_verifier_data_public_inputs(self):
        """Allocate this circuit's own verifier data as public inputs — the
        cyclic-recursion hook (circuit_builder.rs:335).  Layout at the END of
        the public inputs: [..., circuit_digest (4), cap (4 * 2^cap_height)]."""
        assert getattr(self, "verifier_data_public_input", None) is None, \
            "add_verifier_data_public_inputs may only be called once"
        from ..recursion.recursive_verifier import add_virtual_verifier_data
        vdt = add_virtual_verifier_data(self, self.config.fri_config.cap_height)
        self.register_public_inputs(vdt.circuit_digest)
        for h in vdt.constants_sigmas_cap:
            self.register_public_inputs(h)
        self.verifier_data_public_input = vdt
        return vdt

    def connect(self, x: int, y: int) -> None:
        assert tg.is_routable(x, self.config.num_routed_wires), "not routable"
        assert tg.is_routable(y, self.config.num_routed_wires), "not routable"
        self.copy_constraints.append((x, y))

    def assert_zero(self, x: int) -> None:
        self.connect(x, self.zero())

    def is_equal_const(self, t: int):
        return self.targets_to_constants.get(t)

    # -- gates ----------------------------------------------------------------
    def num_gates(self) -> int:
        return len(self.gate_instances)

    def add_gate_to_gate_set(self, gate) -> None:
        """Register a gate type without placing an instance — used to make a
        circuit's gate set (and so its selector layout / CommonCircuitData)
        match a target shape (circuit_builder.rs add_gate_to_gate_set)."""
        self.gate_set.setdefault(gate.id(), gate)

    def add_gate(self, gate, constants: list) -> int:
        assert gate.num_wires() <= self.config.num_wires
        assert len(constants) <= gate.num_constants()
        constants = list(constants) + [0] * (gate.num_constants() - len(constants))
        row = len(self.gate_instances)
        for (ci, wi) in gate.extra_constant_wires():
            self.constant_generators.append([row, ci, wi, 0])
        self.gate_set.setdefault(gate.id(), gate)
        self.gate_instances.append((gate, constants))
        return row

    def find_slot(self, gate, params: tuple, constants: list) -> tuple:
        """(row, op) slot packing (circuit_builder.rs:665)."""
        key = (gate.id(), params)
        num_ops = gate.num_ops
        slot = self.current_slots.get(key)
        if slot is None:
            row = self.add_gate(gate, constants)
            slot = (row, 0)
        row, op = slot
        if op == num_ops - 1:
            self.current_slots.pop(key, None)
        else:
            self.current_slots[key] = (row, op + 1)
        return row, op

    # -- constants ---------------------------------------------------------
    def constant(self, c: int) -> int:
        c = int(c) % gl64.ORDER_INT
        if c in self.constants_to_targets:
            return self.constants_to_targets[c]
        t = self.add_virtual_target()
        self.constants_to_targets[c] = t
        self.targets_to_constants[t] = c
        return t

    def zero(self) -> int:
        return self.constant(0)

    def one(self) -> int:
        return self.constant(1)

    def two(self) -> int:
        return self.constant(2)

    def neg_one(self) -> int:
        return self.constant(gl64.ORDER_INT - 1)

    # -- arithmetic gadget (gadgets/arithmetic.rs:34) -------------------------
    def arithmetic(self, const_0: int, const_1: int, m0: int, m1: int,
                   addend: int) -> int:
        const_0 %= gl64.ORDER_INT
        const_1 %= gl64.ORDER_INT
        special = self._arithmetic_special_cases(const_0, const_1, m0, m1, addend)
        if special is not None:
            return special
        key = (const_0, const_1, m0, m1, addend)
        if key in self.base_arithmetic_results:
            return self.base_arithmetic_results[key]
        gate = ArithmeticGate.new_from_config(self.config)
        row, i = self.find_slot(gate, (const_0, const_1), [const_0, const_1])
        self.connect(m0, tg.wire(row, gate.wire_ith_multiplicand_0(i)))
        self.connect(m1, tg.wire(row, gate.wire_ith_multiplicand_1(i)))
        self.connect(addend, tg.wire(row, gate.wire_ith_addend(i)))
        out = tg.wire(row, gate.wire_ith_output(i))
        self.base_arithmetic_results[key] = out
        return out

    def _arithmetic_special_cases(self, c0, c1, m0, m1, addend):
        zero = self.zero()
        m0c = self.targets_to_constants.get(m0)
        m1c = self.targets_to_constants.get(m1)
        adc = self.targets_to_constants.get(addend)
        first_zero = c0 == 0 or m0 == zero or m1 == zero
        second_zero = c1 == 0 or addend == zero
        if first_zero and second_zero:
            return zero
        if (first_zero or (m0c is not None and m1c is not None)) and \
           (second_zero or adc is not None):
            first = 0 if first_zero else (c0 * m0c * m1c) % gl64.ORDER_INT
            second = 0 if second_zero else (c1 * adc) % gl64.ORDER_INT
            return self.constant((first + second) % gl64.ORDER_INT)
        return None

    def mul(self, a: int, b: int) -> int:
        return self.arithmetic(1, 0, a, b, a)

    def add(self, a: int, b: int) -> int:
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a: int, b: int) -> int:
        return self.arithmetic(1, gl64.ORDER_INT - 1, a, self.one(), b)

    def mul_add(self, a: int, b: int, c: int) -> int:
        return self.arithmetic(1, 1, a, b, c)

    def mul_const(self, c: int, a: int) -> int:
        return self.arithmetic(c, 0, a, self.one(), a)

    def add_const(self, a: int, c: int) -> int:
        return self.arithmetic(1, c, a, self.one(), self.one())

    def square(self, a: int) -> int:
        return self.mul(a, a)

    def add_simple_generator(self, spec: GeneratorSpec) -> None:
        self.generators.append(spec)

    # -- in-circuit hashing (hash/hashing.rs:15, gadgets/hash.rs:19) ---------
    def permute_swapped(self, state: list, swap: int) -> list:
        gate = PoseidonGate()
        row = self.add_gate(gate, [])
        self.connect(swap, tg.wire(row, gate.WIRE_SWAP))
        for i in range(WIDTH):
            self.connect(state[i], tg.wire(row, gate.wire_input(i)))
        return [tg.wire(row, gate.wire_output(i)) for i in range(WIDTH)]

    def hash_n_to_m_no_pad(self, inputs: list, num_outputs: int = 4) -> list:
        zero = self.zero()
        state = [zero] * WIDTH
        false_t = self.zero()
        for start in range(0, len(inputs), 8):
            chunk = inputs[start:start + 8]
            state = chunk + state[len(chunk):]
            state = self.permute_swapped(state, false_t)
        return state[:num_outputs]

    def hash_n_to_hash_no_pad(self, inputs: list) -> list:
        return self.hash_n_to_m_no_pad(inputs, 4)

    # -- lookups (gadgets/lookup.rs:48-123) ----------------------------------
    def add_lookup_table_from_pairs(self, pairs) -> int:
        table = tuple((int(a) & 0xFFFF, int(b) & 0xFFFF) for a, b in pairs)
        assert table, "empty lookup table"
        for i, existing in enumerate(self.luts):
            if existing == table:
                return i
        self.luts.append(table)
        self.lut_to_lookups.append([])
        return len(self.luts) - 1

    def add_lookup_table_from_table(self, inps, outs) -> int:
        return self.add_lookup_table_from_pairs(zip(inps, outs))

    def add_lookup_table_from_fn(self, f, inputs) -> int:
        return self.add_lookup_table_from_pairs((i, f(i)) for i in inputs)

    def add_lookup_from_index(self, looking_in: int, lut_index: int) -> int:
        assert 0 <= lut_index < len(self.luts), f"no LUT {lut_index}"
        looking_out = self.add_virtual_target()
        self.lut_to_lookups[lut_index].append((looking_in, looking_out))
        return looking_out

    def _add_all_lookups(self) -> None:
        """Place LookupGate/LookupTableGate rows for every LUT
        (gadgets/lookup.rs:77-123).  Rows are deliberately 'upside down':
        lookup rows first, then table rows, then one NoopGate so the
        transition constraints read zeros past the end."""
        for lut_index, lut in enumerate(self.luts):
            lookups = self.lut_to_lookups[lut_index]
            assert lookups, f"LUT {lut_index} is unused"
            last_lu_gate = self.num_gates()
            num_lu_slots = LookupGate.slots_from_config(self.config)
            for looking_in, looking_out in lookups:
                gate = LookupGate.new_from_config(self.config, lut_index)
                row, i = self.find_slot(gate, ("lu", lut_index), [])
                self.connect(looking_in,
                             tg.wire(row, gate.wire_ith_looking_inp(i)))
                self.connect(looking_out,
                             tg.wire(row, gate.wire_ith_looking_out(i)))
                self.add_simple_generator(
                    lookup_output_generator(row, i, looking_in, lut_index,
                                            self.luts))
            # pad the final partially-filled row with the first LUT entry
            # (reference plonk/prover.rs:70-85 does this at proving time)
            pad_count = (num_lu_slots - len(lookups) % num_lu_slots) % num_lu_slots
            if pad_count:
                row = self.num_gates() - 1
                for s in range(num_lu_slots - pad_count, num_lu_slots):
                    self.add_simple_generator(GeneratorSpec(
                        "constant", deps=[],
                        outs=[tg.wire(row, LookupGate.wire_ith_looking_inp(s))],
                        params=(lut[0][0],)))
                    self.add_simple_generator(GeneratorSpec(
                        "constant", deps=[],
                        outs=[tg.wire(row, LookupGate.wire_ith_looking_out(s))],
                        params=(lut[0][1],)))
                self.current_slots.pop((LookupGate(num_lu_slots, lut_index).id(),
                                        ("lu", lut_index)), None)

            last_lut_gate = self.num_gates()
            num_lut_slots = LookupTableGate.slots_from_config(self.config)
            num_lut_rows = -(-len(lut) // num_lut_slots)
            for _ in range(num_lut_slots * num_lut_rows):
                gate = LookupTableGate(num_lut_slots, lut_index, last_lut_gate)
                self.find_slot(gate, ("lut", lut_index), [])
            first_lut_gate = self.num_gates() - 1

            # entry e lives at row first_lut_gate - e // slots, slot e % slots
            # (rows upside down, lookup_table.rs generator); fill cells and
            # collect multiplicity wires in entry order
            mult_wires = []
            for e, (a, b) in enumerate(lut):
                row = first_lut_gate - e // num_lut_slots
                s = e % num_lut_slots
                self.add_simple_generator(GeneratorSpec(
                    "constant", deps=[],
                    outs=[tg.wire(row, LookupTableGate.wire_ith_looked_inp(s))],
                    params=(a,)))
                self.add_simple_generator(GeneratorSpec(
                    "constant", deps=[],
                    outs=[tg.wire(row, LookupTableGate.wire_ith_looked_out(s))],
                    params=(b,)))
                mult_wires.append(
                    tg.wire(row, LookupTableGate.wire_ith_multiplicity(s)))
            self.add_simple_generator(multiplicity_generator(
                [lin for lin, _ in lookups], lut_index, self.luts, mult_wires,
                pad_count))

            self.add_gate(NoopGate(), [])
            self.lookup_rows.append((last_lu_gate, last_lut_gate, first_lut_gate))

    def _lookup_selector_values(self, n: int) -> np.ndarray:
        """Lookup selector polynomials (gates/selectors.rs:49-97): 4 shared
        indicator columns + one StartEnd column per LUT."""
        num_shared = LOOKUP_START_END
        polys = np.zeros((num_shared + len(self.lookup_rows), n), dtype=np.uint64)
        for i, (last_lu, last_lut, first_lut) in enumerate(self.lookup_rows):
            polys[LOOKUP_TRANS_SRE, last_lut:first_lut + 1] = 1
            polys[LOOKUP_TRANS_LDC, last_lu:last_lut] = 1
            polys[LOOKUP_INIT_SRE, first_lut + 1] = 1
            polys[LOOKUP_LAST_LDC, last_lu] = 1
            polys[num_shared + i, last_lut] = 1
        return polys

    # -- build ------------------------------------------------------------
    def build(self, device=None) -> CircuitData:
        """Freeze the circuit; constants and sigmas are committed on
        ``device`` (None means CUDA)."""
        device = resolve_device(device)
        config = self.config
        rate_bits = config.fri_config.rate_bits
        cap_height = config.fri_config.cap_height

        self._add_all_lookups()

        num_public_inputs = len(self.public_inputs)
        pis_hash_t = self.hash_n_to_hash_no_pad(list(self.public_inputs))
        pi_gate_obj = PublicInputGate()
        pi_gate = self.add_gate(pi_gate_obj, [])
        for i, t in enumerate(pis_hash_t):
            self.connect(t, tg.wire(pi_gate, i))
        # randomize unused PI-gate wires (circuit_builder.rs:900)
        for w in range(4, config.num_wires):
            self.add_simple_generator(GeneratorSpec(
                "random", deps=[], outs=[tg.wire(pi_gate, w)]))

        # ConstantGates for deduped constants
        while len(self.constants_to_targets) > len(self.constant_generators):
            self.add_gate(ConstantGate(config.num_constants), [])
        const_assignments = sorted(self.constants_to_targets.items(),
                                   key=lambda kv: kv[0])
        for (c, t), cg in zip(const_assignments, self.constant_generators):
            row, ci, wi, _ = cg
            self.gate_instances[row][1][ci] = c
            self.connect(tg.wire(row, wi), t)
            self.add_simple_generator(GeneratorSpec(
                "constant", deps=[], outs=[tg.wire(row, wi)], params=(c,)))

        # blind (zk only) and pad to a power of two (circuit_builder.rs:763)
        if config.zero_knowledge:
            self._blind()
        while len(self.gate_instances) & (len(self.gate_instances) - 1):
            self.add_gate(NoopGate(), [])

        degree = len(self.gate_instances)
        degree_bits = log2_strict(degree)
        fri_params = config.fri_config.fri_params(degree_bits, config.zero_knowledge)
        assert fri_params.total_arities() <= degree_bits + rate_bits - cap_height, \
            "FRI total reduction arity is too large"

        quotient_degree_factor = config.max_quotient_degree_factor
        gates = sorted(self.gate_set.values(), key=lambda g: (g.degree(), g.id()))

        selector_values, selectors_info = self._selector_polynomials(
            gates, quotient_degree_factor + 1)

        # lookup selector columns between gate selectors and gate constants
        # (circuit_builder.rs:988-1004)
        if self.luts:
            lookup_selector_values = self._lookup_selector_values(degree)
            num_lookup_selectors = lookup_selector_values.shape[0]
        else:
            lookup_selector_values = np.zeros((0, degree), dtype=np.uint64)
            num_lookup_selectors = 0

        # constants columns from gate instances
        constant_cols = np.zeros((config.num_constants, degree), dtype=np.uint64)
        for row, (gate, consts) in enumerate(self.gate_instances):
            for j, c in enumerate(consts[:config.num_constants]):
                constant_cols[j, row] = c % gl64.ORDER_INT
        constant_vecs = np.concatenate(
            [selector_values, lookup_selector_values, constant_cols], axis=0)
        num_constants = constant_vecs.shape[0]

        subgroup = gl64.two_adic_subgroup(degree_bits)
        k_is = gl64.powers(gl64.MULTIPLICATIVE_GROUP_GENERATOR,
                           config.num_routed_wires)

        # gate generators (slot-aware: unused slots produce no generators)
        incomplete = {row: op for (gid, params), (row, op) in self.current_slots.items()}
        all_gen_specs = []
        for row, (gate, consts) in enumerate(self.gate_instances):
            if row in self.suppressed_gate_generators:
                continue
            gens = gate.generators(row, consts)
            if row in incomplete:
                gens = gens[: incomplete[row]]
            all_gen_specs.extend(gens)
        all_gen_specs.extend(self.generators)

        schedule = WitnessSchedule(degree, config.num_wires,
                                   self.virtual_target_index,
                                   self.copy_constraints, all_gen_specs)

        sigma_vecs = self._sigma_vecs(schedule, degree, k_is, subgroup)

        constants_sigmas = np.concatenate([constant_vecs, sigma_vecs], axis=0)
        constants_sigmas_commitment = PolynomialBatch.from_values(
            GF.from_u64(constants_sigmas, device), rate_bits, False, cap_height,
            hasher=config.hasher)

        cap = constants_sigmas_commitment.merkle_tree.cap
        # circuit digest (circuit_builder.rs:1090): cap || H_pad("") || degree_bits
        if config.hasher == "keccak":
            pad_empty = np.zeros(12, dtype=np.uint64)
            pad_empty[0] = 1
            pad_empty[-1] = 1
            sep = np.frombuffer(hash_n_to_bytes(pad_empty), dtype=np.uint8)
            digest_input = np.concatenate([
                cap.flatten(), bytes_hash_to_felts(sep).reshape(-1),
                np.array([degree_bits], dtype=np.uint64)])
            circuit_digest = np.frombuffer(hash_n_to_bytes(digest_input),
                                           dtype=np.uint8)
        else:
            domain_sep_digest = _hash_pad_empty()
            digest_input = np.concatenate([
                cap.flatten(), domain_sep_digest,
                np.array([degree_bits], dtype=np.uint64)])
            circuit_digest = hash_no_pad_np(digest_input)

        num_gate_constraints = max(g.num_constraints() for g in gates)
        num_partial_products = -(-config.num_routed_wires // quotient_degree_factor) - 1

        # lookup poly count per challenge: RE + partial SLDCs
        # (circuit_builder.rs:1080)
        if self.luts:
            num_lu_slots = LookupGate.slots_from_config(config)
            num_lookup_polys = 1 + -(-num_lu_slots // (quotient_degree_factor - 1))
        else:
            num_lookup_polys = 0

        common = CommonCircuitData(
            config=config, fri_params=fri_params, gates=gates,
            selectors_info=selectors_info,
            quotient_degree_factor=quotient_degree_factor,
            num_gate_constraints=num_gate_constraints,
            num_constants=num_constants,
            num_public_inputs=num_public_inputs,
            k_is=k_is, num_partial_products=num_partial_products,
            num_lookup_polys=num_lookup_polys,
            num_lookup_selectors=num_lookup_selectors,
            luts=list(self.luts))

        # per-row sigma values for the prover: (degree, num_routed)
        sigmas_rows = sigma_vecs.T.copy()

        prover_only = ProverOnlyCircuitData(
            schedule=schedule,
            constants_sigmas_commitment=constants_sigmas_commitment,
            sigmas=sigmas_rows, subgroup=subgroup,
            public_inputs=self.public_inputs,
            circuit_digest=circuit_digest,
            lookup_rows=list(self.lookup_rows))
        verifier_only = VerifierOnlyCircuitData(
            constants_sigmas_cap=cap, circuit_digest=circuit_digest)
        return CircuitData(prover_only, verifier_only, common)

    # -- zk blinding (circuit_builder.rs:718-820) ----------------------------
    def _num_blinding_gates(self, degree_estimate: int) -> tuple:
        """Openings revealed per polynomial: D at zeta (2D for Zs, also
        opened at g*zeta) plus the FRI query-phase leakage."""
        D = 2
        degree_bits = degree_estimate.bit_length() - 1
        cfg = self.config.fri_config
        params = cfg.fri_params(degree_bits, True)
        arities = [1 << a for a in params.reduction_arity_bits]
        total_folding = sum(a - 1 for a in arities)
        prod = 1
        for a in arities:
            prod *= a
        final_coeffs = degree_estimate // prod
        fri_openings = cfg.num_query_rounds * (
            1 + D * total_folding + D * final_coeffs)
        return (D + fri_openings, 2 * D + fri_openings)

    def _blind(self) -> None:
        """Add blinding rows: one random no-op row per regular opening, and a
        connected random row-pair per Z opening (the 2-cycle that injects a
        uniform factor into Z; mirprotocol blog / circuit_builder.rs:773)."""
        num_gates = len(self.gate_instances)
        degree_estimate = max(1 << (num_gates - 1).bit_length(), 2)
        while True:
            regular, z_openings = self._num_blinding_gates(degree_estimate)
            if num_gates + regular + 2 * z_openings <= degree_estimate:
                break
            degree_estimate *= 2

        for _ in range(regular):
            row = self.add_gate(NoopGate(), [])
            for w in range(self.config.num_wires):
                self.add_simple_generator(GeneratorSpec(
                    "random", deps=[], outs=[tg.wire(row, w)]))
        for _ in range(z_openings):
            row1 = self.add_gate(NoopGate(), [])
            row2 = self.add_gate(NoopGate(), [])
            for w in range(self.config.num_routed_wires):
                self.add_simple_generator(GeneratorSpec(
                    "random", deps=[], outs=[tg.wire(row1, w)]))
                self.connect(tg.wire(row1, w), tg.wire(row2, w))

    # -- build helpers -----------------------------------------------------
    def _selector_polynomials(self, gates: list, max_degree: int):
        """Greedy degree groups (gates/selectors.rs:100-180)."""
        n = len(self.gate_instances)
        num_gates = len(gates)
        index_of = {g.id(): i for i, g in enumerate(gates)}
        max_gate_degree = gates[-1].degree()

        if max_gate_degree + num_gates - 1 <= max_degree:
            poly = np.array([index_of[g.id()] for (g, _) in self.gate_instances],
                            dtype=np.uint64)
            return poly[None, :], SelectorsInfo([0] * num_gates, [range(0, num_gates)])

        assert max_gate_degree < max_degree, \
            f"{gates[-1].id()} has too high degree"

        groups = []
        start = 0
        while start < num_gates:
            size = 0
            while (start + size < num_gates
                   and size + gates[start + size].degree() < max_degree):
                size += 1
            groups.append(range(start, start + size))
            start += size

        def group_of(i):
            for gi, r in enumerate(groups):
                if i in r:
                    return gi
            raise ValueError

        selector_indices = [group_of(i) for i in range(num_gates)]
        polys = np.full((len(groups), n), UNUSED_SELECTOR, dtype=np.uint64)
        for row, (g, _) in enumerate(self.gate_instances):
            i = index_of[g.id()]
            polys[group_of(i), row] = i
        return polys, SelectorsInfo(selector_indices, groups)

    def _sigma_vecs(self, schedule: WitnessSchedule, degree: int,
                    k_is: np.ndarray, subgroup: np.ndarray) -> np.ndarray:
        """sigma polynomials from the copy-constraint partition
        (permutation_argument.rs:89-150): within each class, wires scanned in
        (row, column) order map cyclically to the next member's
        k_{col'} * g^{row'} value.  Returns (num_routed, degree)."""
        num_routed = self.config.num_routed_wires
        num_wires = self.config.num_wires
        parents = schedule.parents

        # dense index of wire (row, col) = row * num_wires + col
        rows = np.repeat(np.arange(degree), num_routed)
        cols = np.tile(np.arange(num_routed), degree)
        dense = rows * num_wires + cols
        reps = parents[dense]
        # group members by rep, preserving (row, col) scan order
        order = np.argsort(reps, kind="stable")
        sorted_reps = reps[order]
        # neighbor = next element in the same rep-class (cyclic)
        boundaries = np.flatnonzero(np.r_[True, sorted_reps[1:] != sorted_reps[:-1]])
        nxt = np.arange(len(sorted_reps)) + 1
        ends = np.r_[boundaries[1:], len(sorted_reps)] - 1
        nxt[ends] = boundaries  # wrap around within class
        neighbor_of = np.empty(len(sorted_reps), dtype=np.int64)
        neighbor_of[order] = order[nxt]

        nrows = rows[neighbor_of]
        ncols = cols[neighbor_of]
        sigma_vals = gl64.mul(k_is[ncols], subgroup[nrows])
        return sigma_vals.reshape(degree, num_routed).T.copy()


def _hash_pad_empty() -> np.ndarray:
    """H_pad("") = hash of the padded empty message: append 1, zero-fill so
    that (len + 1) % WIDTH == 0, append 1 (reference plonk/config.rs:43).
    For empty input that is [1, 0 x 10, 1] of length 12."""
    padded = np.zeros(12, dtype=np.uint64)
    padded[0] = 1
    padded[11] = 1
    return hash_no_pad_np(padded)
