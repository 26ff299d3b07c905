"""Three small multi-table STARK statements tied by cross-table lookups.

``ctl_demo``: a products table (z = x*y on flagged rows) and two request
tables whose flagged rows must all appear in it; one request table carries
a permutation pair, so the shared permutation+CTL Z commitment is
exercised.  ``zkevm_bus_demo``: the zkEVM's LogicStark and MemoryStark,
looked up by a small bus table that stands in for the CPU.  The tables,
traces and seeds are those of the JAX package's tests (tests/test_ctl.py,
tests/test_zkevm.py), so proofs of them can be compared byte for byte.
``aggregation_demo``: the two-table statement that the aggregation
circuits wrap (tests/test_zkevm_aggregation.py).  Each function returns
(starks, ctls, traces), traces as host u64 arrays.
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..stark.ctl import Column, CrossTableLookup, TableWithColumns
from ..stark.permutation import PermutationPair
from ..stark.stark import Stark
from ..zkevm import memory as memmod
from ..zkevm.logic import LogicStark
from ..zkevm.memory import MemoryOp, MemoryStark

N = 32   # rows of every ctl_demo table


class MulStark(Stark):
    """Products table: every row satisfies z = x*y; f flags exported rows."""

    COLUMNS = 4  # x, y, z, f
    PUBLIC_INPUTS = 0

    def eval_generic(self, ctx, vars, yield_constr):
        x, y, z, f = vars.local_values
        yield_constr.constraint(z - x * y)
        yield_constr.constraint(f * (f - ctx.one()))

    def constraint_degree(self):
        return 3


class ReqStark(Stark):
    """Requests table: rows flagged by f must appear in the products table.
    Columns 4/5 are a permutation pair."""

    COLUMNS = 6  # x, y, z, f, c, c_rot
    PUBLIC_INPUTS = 0

    def eval_generic(self, ctx, vars, yield_constr):
        f = vars.local_values[3]
        yield_constr.constraint(f * (f - ctx.one()))

    def constraint_degree(self):
        return 3

    def permutation_pairs(self):
        return [PermutationPair.singletons(4, 5)]


class Req2Stark(Stark):
    """A second requests table without permutation arguments."""

    COLUMNS = 4  # x, y, z, f
    PUBLIC_INPUTS = 0

    def eval_generic(self, ctx, vars, yield_constr):
        f = vars.local_values[3]
        yield_constr.constraint(f * (f - ctx.one()))

    def constraint_degree(self):
        return 3


def ctl_demo_traces() -> list:
    """[products, requests 1, requests 2]: the 20 exported product rows
    split 12 / 8 between the request tables (seed 7)."""
    x = np.arange(N, dtype=np.uint64)
    y = x + np.uint64(3)
    mul = np.stack([x, y, gl64.mul(x, y), np.zeros(N, np.uint64)])
    mul[3, :20] = 1
    rows = mul[:3, :20]
    rng = np.random.default_rng(7)
    order = rng.permutation(20)
    r1, r2 = order[:12], order[12:]

    req1 = np.zeros((6, N), np.uint64)
    req1[:3, :12] = rows[:, r1]
    req1[3, :12] = 1
    req1[:3, 12:] = rng.integers(0, 100, size=(3, N - 12))  # f=0 rows: junk
    req1[4] = np.arange(N, dtype=np.uint64)
    req1[5] = np.roll(req1[4], 1)

    req2 = np.zeros((4, N), np.uint64)
    # filtered rows scattered: filters need not be a prefix
    pos = np.asarray(sorted(rng.choice(N, size=8, replace=False)))
    req2[:3, pos] = rows[:, r2]
    req2[3, pos] = 1
    return [mul, req1, req2]


def ctl_demo_ctls() -> list:
    cols = Column.singles([0, 1, 2])
    return [CrossTableLookup(
        looking_tables=(
            TableWithColumns(1, tuple(cols), Column.single(3)),
            TableWithColumns(2, tuple(cols), Column.single(3)),
        ),
        looked_table=TableWithColumns(0, tuple(cols), Column.single(3)),
    )]


def ctl_demo() -> tuple:
    return ([MulStark(), ReqStark(), Req2Stark()], ctl_demo_ctls(),
            ctl_demo_traces())


def aggregation_demo() -> tuple:
    """The JAX package's tests/test_zkevm_aggregation.py statement: a
    products table and one requests table holding its 16 exported rows in
    a shuffled order (seed 5), the multi-table proof that the aggregation
    circuits wrap."""
    x = np.arange(N, dtype=np.uint64)
    y = x + np.uint64(3)
    f = np.zeros(N, np.uint64)
    f[:16] = 1
    mul = np.stack([x, y, gl64.mul(x, y), f])
    req = np.zeros((4, N), np.uint64)
    order = np.random.default_rng(5).permutation(16)
    req[:3, :16] = mul[:3, :16][:, order]
    req[3, :16] = 1
    cols = Column.singles([0, 1, 2])
    ctls = [CrossTableLookup(
        looking_tables=(TableWithColumns(1, tuple(cols), Column.single(3)),),
        looked_table=TableWithColumns(0, tuple(cols), Column.single(3)))]
    return [MulStark(), Req2Stark()], ctls, [mul, req]


class BusStark(Stark):
    """Mini CPU stand-in: requests logic ops and memory reads over CTLs."""

    PUBLIC_INPUTS = 0

    def __init__(self, logic: LogicStark):
        # logic bus width (flags + 2 inputs + result) + memory bus width
        self.logic_width = 3 + 3 * logic.packed_len
        self.mem_width = 4 + 8 + 1
        # [logic_filter, logic row..., mem_filter, mem row...]
        self.LOGIC_FILTER = 0
        self.LOGIC = range(1, 1 + self.logic_width)
        self.MEM_FILTER = self.LOGIC.stop
        self.MEM = range(self.MEM_FILTER + 1,
                         self.MEM_FILTER + 1 + self.mem_width)
        self.COLUMNS = self.MEM.stop

    def eval_generic(self, ctx, vars, yield_constr):
        one = ctx.one()
        for f in (self.LOGIC_FILTER, self.MEM_FILTER):
            yield_constr.constraint(
                vars.local_values[f] * (vars.local_values[f] - one))

    def constraint_degree(self):
        return 3

    def ctl_looking_logic(self):
        return TableWithColumns(
            2, tuple(Column.singles(self.LOGIC)),
            Column.single(self.LOGIC_FILTER))

    def ctl_looking_memory(self):
        return TableWithColumns(
            2, tuple(Column.singles(self.MEM)),
            Column.single(self.MEM_FILTER))


def _memory_ops(rng, n_addrs: int, n_ops: int) -> list:
    ops = []
    vals = {}
    for t in range(n_ops):
        addr = (0, 1, int(rng.integers(0, n_addrs)))
        if addr in vals and rng.integers(0, 2) == 0:
            ops.append(MemoryOp(True, 2 * t + 1, True, *addr, vals[addr]))
        else:
            v = int(rng.integers(0, 1 << 62))
            vals[addr] = v
            ops.append(MemoryOp(True, 2 * t + 1, False, *addr, v))
    return ops


def zkevm_bus_demo() -> tuple:
    """[logic, memory, bus]: four 64-bit logic ops and ten memory ops
    (seed 11), every filtered row of both looked up by the bus."""
    rng = np.random.default_rng(11)
    logic = LogicStark(val_bits=64)
    memory = MemoryStark()
    bus = BusStark(logic)

    logic_ops = [(op, int(rng.integers(0, 1 << 63)),
                  int(rng.integers(0, 1 << 63)))
                 for op in ("and", "xor") for _ in range(2)]
    mem_ops = _memory_ops(rng, n_addrs=3, n_ops=10)

    # cap_height=4 Merkle caps need >= 2^4 LDE leaves per oracle
    logic_trace = logic.generate_trace(logic_ops, min_rows=16)
    mem_trace = memory.generate_trace(mem_ops)

    n = 16
    bus_trace = np.zeros((bus.COLUMNS, n), np.uint64)
    lrows = np.stack([c.eval_rows(logic_trace) for c in logic.ctl_data()])
    lfilt = logic.ctl_filter().eval_rows(logic_trace)
    idx = np.nonzero(gl64.to_canonical(lfilt))[0]
    bus_trace[bus.LOGIC.start:bus.LOGIC.stop, :len(idx)] = lrows[:, idx]
    bus_trace[bus.LOGIC_FILTER, :len(idx)] = 1

    mrows = np.stack([c.eval_rows(mem_trace) for c in memmod.ctl_data()])
    mfilt = memmod.ctl_filter().eval_rows(mem_trace)
    midx = np.nonzero(gl64.to_canonical(mfilt))[0]
    bus_trace[bus.MEM.start:bus.MEM.stop, :len(midx)] = mrows[:, midx]
    bus_trace[bus.MEM_FILTER, :len(midx)] = 1

    starks = [logic, memory, bus]
    ctls = [
        CrossTableLookup(
            looking_tables=(bus.ctl_looking_logic(),),
            looked_table=TableWithColumns(0, tuple(logic.ctl_data()),
                                          logic.ctl_filter())),
        CrossTableLookup(
            looking_tables=(bus.ctl_looking_memory(),),
            looked_table=TableWithColumns(1, tuple(memmod.ctl_data()),
                                          memmod.ctl_filter())),
    ]
    return starks, ctls, [logic_trace, mem_trace, bus_trace]
