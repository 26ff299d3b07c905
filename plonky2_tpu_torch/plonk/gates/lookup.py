"""LookupGate / LookupTableGate (twins of reference gates/lookup.rs:30 and
gates/lookup_table.rs:31).

Neither gate contributes main-trace constraints: the logUp argument lives in
the lookup Z polynomials checked by `check_lookup_constraints`
(plonk/vanishing.py).  The gates only lay out wires:
  * LookupGate: num_slots (input, output) pairs per row, each copy-constrained
    to a user lookup;
  * LookupTableGate: num_slots (input, output, multiplicity) triples per row
    materialising the table itself.

Witness generation differs from the reference: instead of the prover-side
`set_lookup_wires` pass (reference plonk/prover.rs:37), table cells are
constant generators, lookup outputs are per-slot table probes, and the
multiplicity row is one batched counting generator whose deps are every
looking input of the LUT — the static schedule orders it automatically.
"""

from __future__ import annotations

import numpy as np

from .. import targets
from .base import EvalVars, Gate, GeneratorSpec


class LookupGate(Gate):
    """(input, output) lookup pairs; 2 wires per slot."""

    def __init__(self, num_slots: int, lut_index: int):
        self.num_slots = num_slots
        self.lut_index = lut_index

    @staticmethod
    def slots_from_config(config) -> int:
        return config.num_routed_wires // 2

    @classmethod
    def new_from_config(cls, config, lut_index: int) -> "LookupGate":
        return cls(cls.slots_from_config(config), lut_index)

    # find_slot packing interface
    @property
    def num_ops(self):
        return self.num_slots

    def id(self):
        return f"LookupGate {{ num_slots: {self.num_slots}, lut: {self.lut_index} }}"

    @staticmethod
    def wire_ith_looking_inp(i):
        return 2 * i

    @staticmethod
    def wire_ith_looking_out(i):
        return 2 * i + 1

    def num_wires(self):
        return 2 * self.num_slots

    def degree(self):
        return 0

    def num_constraints(self):
        return 0

    def eval_unfiltered(self, ctx, vars: EvalVars):
        return []

    def generators(self, row, local_constants):
        # Outputs are filled by the builder (which owns the LUT contents) via
        # per-slot probe generators — see BuilderLookups.add_all_lookups.
        return []


class LookupTableGate(Gate):
    """(input, output, multiplicity) table triples; 3 wires per slot."""

    def __init__(self, num_slots: int, lut_index: int, last_lut_row: int):
        self.num_slots = num_slots
        self.lut_index = lut_index
        self.last_lut_row = last_lut_row

    @staticmethod
    def slots_from_config(config) -> int:
        return config.num_routed_wires // 3

    def id(self):
        return (f"LookupTableGate {{ num_slots: {self.num_slots}, "
                f"lut: {self.lut_index}, last_lut_row: {self.last_lut_row} }}")

    @property
    def num_ops(self):
        return self.num_slots

    @staticmethod
    def wire_ith_looked_inp(i):
        return 3 * i

    @staticmethod
    def wire_ith_looked_out(i):
        return 3 * i + 1

    @staticmethod
    def wire_ith_multiplicity(i):
        return 3 * i + 2

    def num_wires(self):
        return 3 * self.num_slots

    def degree(self):
        return 0

    def num_constraints(self):
        return 0

    def eval_unfiltered(self, ctx, vars: EvalVars):
        return []

    def generators(self, row, local_constants):
        return []


def lookup_output_generator(row: int, slot: int, looking_in: int,
                            lut_index: int, luts: list) -> GeneratorSpec:
    """Probe generator: out_wire = LUT[in] (reference LookupGenerator)."""
    from ..generators import build_custom_fn
    out_wire = targets.wire(row, LookupGate.wire_ith_looking_out(slot))
    return GeneratorSpec(kind="custom", deps=[looking_in], outs=[out_wire],
                         fn=build_custom_fn("lookup_output", (lut_index,), luts),
                         params=(lut_index,), name="lookup_output")


def multiplicity_generator(looking_inputs: list, lut_index: int, luts: list,
                           mult_wires: list, pad_count: int) -> GeneratorSpec:
    """One batched generator computing every multiplicity wire of a LUT.

    `pad_count` extra probes of the first LUT entry account for the padding
    slots in the final LookupGate row (reference plonk/prover.rs:70-85)."""
    from ..generators import build_custom_fn
    return GeneratorSpec(kind="custom", deps=list(looking_inputs),
                         outs=list(mult_wires),
                         fn=build_custom_fn("lookup_mult",
                                            (lut_index, pad_count), luts),
                         params=(lut_index, pad_count), name="lookup_mult")
