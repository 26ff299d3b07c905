"""Memory-consistency STARK table (twin of reference
evm/src/memory/memory_stark.rs).

Operations are sorted by (context, segment, virtual, timestamp); the AIR
enforces the sort order by range-checking the delta of the first address
component that changes (or the timestamp delta when the address repeats),
and enforces read-consistency: a read at an unchanged address must return
the previous value.  The range check itself is a Halo2-style in-table
lookup of RANGE_CHECK into the COUNTER column 0..n-1 (lookup.py), tied by
the STARK permutation argument.

Trace generation (sorting, gap filling, flag columns) is vectorised numpy
instead of the reference's per-row loops (memory_stark.rs:74-140)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gl64
from ..stark.ctl import Column
from ..stark.permutation import PermutationPair
from ..stark.stark import Stark
from .lookup import eval_lookups, permuted_cols

P = gl64.ORDER_INT

VALUE_LIMBS = 8

# column layout (memory/columns.rs, contiguous — no reserved channel gap)
FILTER = 0
TIMESTAMP = 1
IS_READ = 2
ADDR_CONTEXT = 3
ADDR_SEGMENT = 4
ADDR_VIRTUAL = 5
VALUE_START = 6


def value_limb(i: int) -> int:
    return VALUE_START + i


CONTEXT_FIRST_CHANGE = VALUE_START + VALUE_LIMBS
SEGMENT_FIRST_CHANGE = CONTEXT_FIRST_CHANGE + 1
VIRTUAL_FIRST_CHANGE = SEGMENT_FIRST_CHANGE + 1
RANGE_CHECK = VIRTUAL_FIRST_CHANGE + 1
COUNTER = RANGE_CHECK + 1
RANGE_CHECK_PERMUTED = COUNTER + 1
COUNTER_PERMUTED = RANGE_CHECK_PERMUTED + 1
NUM_COLUMNS = COUNTER_PERMUTED + 1


def ctl_data() -> list:
    """The memory bus row: is_read, address triple, 8 value limbs,
    timestamp (memory_stark.rs:29)."""
    return Column.singles(
        [IS_READ, ADDR_CONTEXT, ADDR_SEGMENT, ADDR_VIRTUAL]
        + [value_limb(i) for i in range(VALUE_LIMBS)] + [TIMESTAMP])


def ctl_filter() -> Column:
    return Column.single(FILTER)


@dataclass(frozen=True)
class MemoryOp:
    """(witness/memory.rs MemoryOp) — value is a 256-bit int."""

    filter: bool
    timestamp: int
    is_read: bool
    context: int
    segment: int
    virt: int
    value: int

    def sorting_key(self):
        return (self.context, self.segment, self.virt, self.timestamp)


def dummy_read(op: MemoryOp, timestamp: int = None, virt: int = None,
               value: int = None) -> MemoryOp:
    return MemoryOp(False, op.timestamp if timestamp is None else timestamp,
                    True, op.context, op.segment,
                    op.virt if virt is None else virt,
                    op.value if value is None else value)


class MemoryStark(Stark):
    COLUMNS = NUM_COLUMNS
    PUBLIC_INPUTS = 0

    def fill_gaps(self, ops: list) -> list:
        """Insert dummy reads so every ordering delta fits the range check
        (memory_stark.rs:163)."""
        max_rc = (1 << (len(ops) - 1).bit_length()) - 1 if len(ops) > 1 else 0
        out = list(ops)
        for curr, nxt in zip(ops, ops[1:]):
            if (curr.context != nxt.context or curr.segment != nxt.segment):
                continue  # context/segment gaps are small by construction
            elif curr.virt != nxt.virt:
                while nxt.virt - curr.virt - 1 > max_rc:
                    curr = dummy_read(curr, timestamp=0,
                                      virt=curr.virt + max_rc + 1, value=0)
                    out.append(curr)
            else:
                while nxt.timestamp - curr.timestamp > max_rc:
                    curr = dummy_read(curr,
                                      timestamp=curr.timestamp + max_rc)
                    out.append(curr)
        return out

    def generate_trace(self, memory_ops: list) -> np.ndarray:
        """(NUM_COLUMNS, n) u64 trace (memory_stark.rs:215)."""
        ops = sorted(memory_ops, key=MemoryOp.sorting_key)
        ops = sorted(self.fill_gaps(ops), key=MemoryOp.sorting_key)
        # pad with filtered-out repeats of the last op (must be reads)
        n = 1 << (len(ops) - 1).bit_length()
        ops = ops + [dummy_read(ops[-1])] * (n - len(ops))

        t = np.zeros((NUM_COLUMNS, n), np.uint64)
        t[FILTER] = [op.filter for op in ops]
        t[TIMESTAMP] = [op.timestamp for op in ops]
        t[IS_READ] = [op.is_read for op in ops]
        t[ADDR_CONTEXT] = [op.context for op in ops]
        t[ADDR_SEGMENT] = [op.segment for op in ops]
        t[ADDR_VIRTUAL] = [op.virt for op in ops]
        for j in range(VALUE_LIMBS):
            t[value_limb(j)] = [(op.value >> (32 * j)) & 0xFFFFFFFF
                                for op in ops]

        # first-change flags + range-check column, vectorised over row pairs
        # (generate_first_change_flags_and_rc, memory_stark.rs:74)
        c, s, v, ts = (t[ADDR_CONTEXT], t[ADDR_SEGMENT], t[ADDR_VIRTUAL],
                       t[TIMESTAMP])
        cc = c[:-1] != c[1:]
        sc = (s[:-1] != s[1:]) & ~cc
        vc = (v[:-1] != v[1:]) & ~cc & ~sc
        unchanged = ~cc & ~sc & ~vc
        t[CONTEXT_FIRST_CHANGE, :-1] = cc
        t[SEGMENT_FIRST_CHANGE, :-1] = sc
        t[VIRTUAL_FIRST_CHANGE, :-1] = vc
        rc = np.where(
            cc, gl64.sub(gl64.sub(c[1:], c[:-1]), np.uint64(1)),
            np.where(sc, gl64.sub(gl64.sub(s[1:], s[:-1]), np.uint64(1)),
                     np.where(vc, gl64.sub(gl64.sub(v[1:], v[:-1]),
                                           np.uint64(1)),
                              gl64.sub(ts[1:], ts[:-1]))))
        assert np.all(gl64.to_canonical(rc) < n), \
            "range check too large; fill_gaps bug"
        t[RANGE_CHECK, :-1] = rc

        t[COUNTER] = np.arange(n, dtype=np.uint64)
        t[RANGE_CHECK_PERMUTED], t[COUNTER_PERMUTED] = permuted_cols(
            t[RANGE_CHECK], t[COUNTER])
        return t

    def eval_generic(self, ctx, vars, yield_constr) -> None:
        """(memory_stark.rs:244)"""
        lv, nv = vars.local_values, vars.next_values
        one = ctx.one()

        timestamp, addr_c, addr_s, addr_v = (
            lv[TIMESTAMP], lv[ADDR_CONTEXT], lv[ADDR_SEGMENT],
            lv[ADDR_VIRTUAL])
        values = [lv[value_limb(i)] for i in range(VALUE_LIMBS)]
        next_ts, next_is_read = nv[TIMESTAMP], nv[IS_READ]
        next_c, next_s, next_v = (nv[ADDR_CONTEXT], nv[ADDR_SEGMENT],
                                  nv[ADDR_VIRTUAL])
        next_values = [nv[value_limb(i)] for i in range(VALUE_LIMBS)]

        filt = lv[FILTER]
        yield_constr.constraint(filt * (filt - one))
        # dummy rows must be reads (cannot inject writes)
        yield_constr.constraint((one - filt) * (one - lv[IS_READ]))

        cfc = lv[CONTEXT_FIRST_CHANGE]
        sfc = lv[SEGMENT_FIRST_CHANGE]
        vfc = lv[VIRTUAL_FIRST_CHANGE]
        unchanged = one - cfc - sfc - vfc
        rc = lv[RANGE_CHECK]

        for flag in (cfc, sfc, vfc, unchanged):
            yield_constr.constraint(flag * (one - flag))

        # no change in components before the first-change one
        yield_constr.constraint_transition(sfc * (next_c - addr_c))
        yield_constr.constraint_transition(vfc * (next_c - addr_c))
        yield_constr.constraint_transition(vfc * (next_s - addr_s))
        yield_constr.constraint_transition(unchanged * (next_c - addr_c))
        yield_constr.constraint_transition(unchanged * (next_s - addr_s))
        yield_constr.constraint_transition(unchanged * (next_v - addr_v))

        computed_rc = (cfc * (next_c - addr_c - one)
                       + sfc * (next_s - addr_s - one)
                       + vfc * (next_v - addr_v - one)
                       + unchanged * (next_ts - timestamp))
        yield_constr.constraint_transition(rc - computed_rc)

        # reads at an unchanged address return the previous value
        for i in range(VALUE_LIMBS):
            yield_constr.constraint_transition(
                next_is_read * unchanged * (next_values[i] - values[i]))

        # reads at a fresh (never-written) address return 0 — the
        # deterministic-machine rule the simulator assumes
        # (Simulator.mem_access: memory.get(..., 0)).  Without it MLOAD
        # or the sponge's byte reads over unwritten addresses could
        # return arbitrary prover-chosen values.  The first row of a new
        # address group is exactly where (cfc + sfc + vfc) is set on the
        # previous row; the very first table row is covered separately.
        first_change = cfc + sfc + vfc
        for i in range(VALUE_LIMBS):
            yield_constr.constraint_transition(
                first_change * next_is_read * next_values[i])
            yield_constr.constraint_first_row(lv[IS_READ] * values[i])

        eval_lookups(ctx, vars, yield_constr, RANGE_CHECK_PERMUTED,
                     COUNTER_PERMUTED)

    def constraint_degree(self) -> int:
        return 3

    def permutation_pairs(self) -> list:
        return [PermutationPair.singletons(RANGE_CHECK, RANGE_CHECK_PERMUTED),
                PermutationPair.singletons(COUNTER, COUNTER_PERMUTED)]
