"""Cross-table lookups (twin of reference evm/src/cross_table_lookup.rs).

A CTL ties several STARK tables into one statement: the filtered rows of
the "looking" tables — each row's selected columns folded into one field
element with random (beta, gamma) challenges — must form the same multiset
as the filtered rows of one "looked" table.  Per (table occurrence,
challenge) the prover commits a running-product Z column; since every
factor appears exactly once across the looking tables iff it appears once
in the looked table, the verifier only has to check

    prod over looking tables of Z_looking(g^{n-1}) == Z_looked(g^{n-1})

plus, inside each table's AIR, that Z really is the running product
(eval_cross_table_lookup_checks).

Everything here is ctx-polymorphic like the rest of the stark layer: the
same `Column.eval` / check code serves the prover (whole-coset GF batches)
and the verifier (host E2 scalars at zeta).  The Z columns themselves are
computed on the prover's device (stark/multi.py
cross_table_lookup_data_gf) with a log-depth prefix-product scan instead
of the reference's row-serial loop (cross_table_lookup.rs:279-306).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..field import gl64

P = gl64.ORDER_INT


@dataclass(frozen=True)
class Column:
    """Linear combination of a table's columns plus a constant
    (cross_table_lookup.rs:26)."""

    linear_combination: tuple  # of (column_index, int coefficient)
    constant: int = 0

    @staticmethod
    def single(c: int) -> "Column":
        return Column(((c, 1),))

    @staticmethod
    def singles(cs) -> list:
        return [Column.single(c) for c in cs]

    @staticmethod
    def constant_col(v: int) -> "Column":
        return Column((), int(v) % P)

    @staticmethod
    def zero() -> "Column":
        return Column.constant_col(0)

    @staticmethod
    def one() -> "Column":
        return Column.constant_col(1)

    @staticmethod
    def linear(pairs, constant: int = 0) -> "Column":
        pairs = tuple((c, int(k) % P) for c, k in pairs)
        assert len({c for c, _ in pairs}) == len(pairs), "duplicate columns"
        return Column(pairs, int(constant) % P)

    @staticmethod
    def le_bits(cs) -> "Column":
        return Column.linear((c, 1 << i) for i, c in enumerate(cs))

    @staticmethod
    def le_bytes(cs) -> "Column":
        return Column.linear((c, 1 << (8 * i)) for i, c in enumerate(cs))

    @staticmethod
    def sum_cols(cs) -> "Column":
        return Column.linear((c, 1) for c in cs)

    def eval_rows(self, trace: np.ndarray) -> np.ndarray:
        """Vectorised host evaluation over every row; trace is (COLS, n) u64
        (cross_table_lookup.rs:110 eval_table, all rows at once)."""
        n = trace.shape[-1]
        acc = np.full(n, np.uint64(self.constant))
        for c, k in self.linear_combination:
            acc = gl64.add(acc, gl64.mul(trace[c], np.uint64(k)))
        return acc

    def eval(self, ctx, values: list):
        """ctx-polymorphic evaluation on one row of ctx elements
        (cross_table_lookup.rs:97 / :118)."""
        acc = ctx.constant(self.constant)
        # a unit coefficient needs no multiply (most filters and packed
        # limbs); the sum is the same field element either way.  A circuit
        # ctx keeps the multiply: its gates are the reference's circuit
        skip_unit = not getattr(ctx, "builds_circuit", False)
        for c, k in self.linear_combination:
            acc = acc + (values[c] if k == 1 and skip_unit
                         else values[c] * ctx.constant(k))
        return acc


@dataclass(frozen=True)
class TableWithColumns:
    """One side of a CTL: a table index, the columns looked up, and an
    optional binary filter column (cross_table_lookup.rs:142)."""

    table: int
    columns: tuple  # of Column
    filter_column: Column = None


@dataclass(frozen=True)
class CrossTableLookup:
    """(cross_table_lookup.rs:159)"""

    looking_tables: tuple  # of TableWithColumns
    looked_table: TableWithColumns

    def __post_init__(self):
        assert all(len(t.columns) == len(self.looked_table.columns)
                   for t in self.looking_tables)


def num_ctl_zs(ctls, table: int, num_challenges: int) -> int:
    """Z-column count for one table (cross_table_lookup.rs:178)."""
    count = 0
    for ctl in ctls:
        for twc in (ctl.looked_table, *ctl.looking_tables):
            if twc.table == table:
                count += 1
    return count * num_challenges


@dataclass(frozen=True)
class GrandProductChallenge:
    """Random (beta, gamma) folding a row to one element
    (evm/src/permutation.rs:53): combine(ts) = sum_i ts[i] beta^i + gamma."""

    beta: int
    gamma: int

    def combine(self, ctx, terms: list):
        """beta/gamma may be host ints (prover/verifier) or wrapped circuit
        elements (recursive verifier), like permutation.py's elem()."""
        def elem(v):
            return (ctx.constant(int(v))
                    if isinstance(v, (int, np.integer)) else v)

        beta = elem(self.beta)
        acc = elem(self.gamma)
        w = None
        for t in terms:
            if w is None:
                acc = acc + t
                w = beta
            else:
                acc = acc + t * w
                w = w * beta
        return acc


def get_grand_product_challenge_set(challenger, num_challenges: int) -> list:
    """(evm/src/permutation.rs:264) — works for host and recursive
    challengers alike (beta then gamma per challenge)."""
    out = []
    for _ in range(num_challenges):
        beta = challenger.get_challenge()
        gamma = challenger.get_challenge()
        out.append(GrandProductChallenge(beta, gamma))
    return out


@dataclass
class CtlZData:
    """One committed Z column plus how to re-derive its factors
    (cross_table_lookup.rs:196)."""

    z: object  # (n,) GF on the prover's device
    challenge: GrandProductChallenge
    columns: tuple
    filter_column: Column


@dataclass
class CtlData:
    """Per-table CTL prover data (cross_table_lookup.rs:190)."""

    zs_columns: list = field(default_factory=list)

    def __len__(self):
        return len(self.zs_columns)


@dataclass
class CtlCheckVars:
    """Openings + metadata for checking one Z column inside a table's AIR
    (cross_table_lookup.rs:309).  local_z/next_z are ctx elements."""

    local_z: object
    next_z: object
    challenge: GrandProductChallenge
    columns: tuple
    filter_column: Column


def ctl_check_vars_for_table(ctls: list, ctl_challenges: list, table: int,
                             zs: list) -> list:
    """CtlCheckVars for one table from its (local_z, next_z) opening pairs,
    in prover Z order (cross_table_lookup.rs:425 from_proof)."""
    it = iter(zs)
    out = []
    for ctl in ctls:
        for challenge in ctl_challenges:
            for twc in (*ctl.looking_tables, ctl.looked_table):
                if twc.table == table:
                    local_z, next_z = next(it)
                    out.append(CtlCheckVars(
                        local_z, next_z, challenge, twc.columns,
                        twc.filter_column))
    assert next(it, None) is None, "leftover CTL Z openings"
    return out


def ctl_check_vars_per_table(ctls: list, ctl_challenges: list,
                             num_tables: int, zs_per_table: list) -> list:
    """Distribute per-table (local_z, next_z) opening pairs to CtlCheckVars
    in prover Z order (cross_table_lookup.rs:325 from_proofs).
    zs_per_table: per table a list of (local_z, next_z) ctx-element pairs."""
    return [ctl_check_vars_for_table(ctls, ctl_challenges, t, zs)
            for t, zs in enumerate(zs_per_table)]


def eval_cross_table_lookup_checks(ctx, vars, ctl_vars: list,
                                   consumer) -> None:
    """AIR constraints making Z a genuine running product
    (cross_table_lookup.rs:374): Z(1) = select(f(1), comb(1)) and
    Z(gw) = Z(w) * select(f(gw), comb(gw)), select(f, x) = f*x + 1 - f."""
    one = ctx.one()
    # every challenge checks the same columns and filters: evaluate each
    # (column, row) once, except in a circuit ctx, which builds the
    # reference's circuit
    evals = {}
    reuse = not getattr(ctx, "builds_circuit", False)

    def column_eval(column, values):
        key = (column, id(values))
        if not reuse:
            return column.eval(ctx, values)
        if key not in evals:
            evals[key] = column.eval(ctx, values)
        return evals[key]

    def select(filt, x):
        if filt is None:
            return x
        return filt * x + one - filt

    for cv in ctl_vars:
        def filt_of(values):
            if cv.filter_column is None:
                return None
            return column_eval(cv.filter_column, values)

        def comb_of(values):
            return cv.challenge.combine(
                ctx, [column_eval(c, values) for c in cv.columns])

        consumer.constraint_first_row(
            cv.local_z - select(filt_of(vars.local_values),
                                comb_of(vars.local_values)))
        consumer.constraint_transition(
            cv.next_z - cv.local_z * select(filt_of(vars.next_values),
                                            comb_of(vars.next_values)))


def verify_cross_table_lookups(ctls: list, ctl_zs_lasts: list,
                               num_challenges: int) -> None:
    """Tie the tables together: per (CTL, challenge) the product of looking
    tables' final Z values equals the looked table's
    (cross_table_lookup.rs:542).  ctl_zs_lasts: per table (k,) u64."""
    iters = [iter(np.asarray(v, np.uint64)) for v in ctl_zs_lasts]
    for ctl in ctls:
        for _ in range(num_challenges):
            prod = np.uint64(1)
            for twc in ctl.looking_tables:
                prod = gl64.mul(prod, next(iters[twc.table]))
            looked = next(iters[ctl.looked_table.table])
            assert gl64.to_canonical(prod) == gl64.to_canonical(looked), \
                "cross-table lookup verification failed"
    for it in iters:
        assert next(it, None) is None, "leftover ctl_zs_last openings"


def check_ctls(trace_poly_values: list, ctls: list) -> None:
    """Debug multiset check over raw traces (cross_table_lookup.rs:610)."""
    for idx, ctl in enumerate(ctls):
        looking = {}
        looked = {}
        for twc, multiset in ([(t, looking) for t in ctl.looking_tables]
                              + [(ctl.looked_table, looked)]):
            trace = trace_poly_values[twc.table]
            filt = (gl64.to_canonical(twc.filter_column.eval_rows(trace))
                    if twc.filter_column is not None
                    else np.ones(trace.shape[-1], np.uint64))
            rows = np.stack(
                [gl64.to_canonical(c.eval_rows(trace)) for c in twc.columns],
                axis=-1)
            for i in np.nonzero(filt)[0]:
                key = tuple(int(v) for v in rows[i])
                multiset[key] = multiset.get(key, 0) + 1
        assert looking == looked, \
            f"CTL #{idx} multiset mismatch: {looking} vs {looked}"
