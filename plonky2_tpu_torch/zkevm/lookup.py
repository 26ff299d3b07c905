"""In-table (Halo2-style) lookups for zkEVM tables (twin of reference
evm/src/lookup.rs).

A column of inputs is constrained to take values from a table column by
committing sorted copies of both: the sorted input must either repeat its
predecessor or equal the sorted-table value on the same row.  The sorted
copies are tied to the originals with the STARK permutation argument
(PermutationPair on the caller's side)."""

from __future__ import annotations

import numpy as np

from ..field import gl64


def eval_lookups(ctx, vars, yield_constr, col_permuted_input: int,
                 col_permuted_table: int) -> None:
    """(lookup.rs:13) (in'-in)(in'-tab') = 0 everywhere; the wrap-around
    row instead requires in(0) = tab(0), expressed as a last-row constraint
    on the next-row diff."""
    local_perm_input = vars.local_values[col_permuted_input]
    next_perm_table = vars.next_values[col_permuted_table]
    next_perm_input = vars.next_values[col_permuted_input]

    diff_input_prev = next_perm_input - local_perm_input
    diff_input_table = next_perm_input - next_perm_table
    yield_constr.constraint(diff_input_prev * diff_input_table)
    yield_constr.constraint_last_row(diff_input_table)


def permuted_cols(inputs: np.ndarray, table: np.ndarray) -> tuple:
    """Sorted input column + matching permuted table column (lookup.rs:68),
    fully vectorised (the reference walks both sorted columns with a
    serial two-pointer loop): place each *first occurrence* of an input
    value against its table copy, then backfill the repeat rows with the
    leftover table values.  The outputs satisfy the Halo2 condition —
    every row has input == table or input == previous input — and are
    true permutations of their sources."""
    n = inputs.shape[0]
    sorted_inputs = np.sort(gl64.to_canonical(np.asarray(inputs, np.uint64)))
    sorted_table = np.sort(gl64.to_canonical(np.asarray(table, np.uint64)))

    first = np.ones(n, bool)
    first[1:] = sorted_inputs[1:] != sorted_inputs[:-1]
    vals = sorted_inputs[first]
    idx = np.searchsorted(sorted_table, vals)
    assert idx[-1] < n and np.array_equal(sorted_table[idx], vals), \
        "lookup input value missing from table"
    used = np.zeros(n, bool)
    used[idx] = True  # idx strictly increasing: one table copy per value
    permuted_table = np.empty(n, np.uint64)
    permuted_table[first] = vals
    permuted_table[~first] = sorted_table[~used]
    return sorted_inputs, permuted_table
