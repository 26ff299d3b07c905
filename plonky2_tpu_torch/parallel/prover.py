"""Sharded proving stages over a mesh of ranks.

The prover's hot phases laid out for collectives (SURVEY §2.5: the
reference's rayon loops, fri/oracle.rs:55-107 parallel IFFT/LDE,
hash/merkle_tree.rs:69-131 parallel tree fill, prover.rs:576 quotient
batches, become one process per device):

- ``sharded_commitment``: the PolynomialBatch commit (IFFT -> coset LDE
  -> bit-reverse -> transpose -> leaf hash -> Merkle reduce,
  fri/oracle.rs:43-100) with polynomials sharded over the mesh for the
  transform phase, one all_to_all transpose to switch to row sharding,
  local Merkle subtree reduction, and an all_gather of the last local
  digest level.  Communication: one all_to_all of the LDE matrix plus the
  small gather.
- ``sharded_stark_quotient_values``: STARK constraint evaluation over the
  quotient coset sharded by rows; ``next_values`` cross the shard boundary
  through a halo exchange (``mesh.roll_left``).
"""

from __future__ import annotations

import numpy as np

from ..field import gl64, ntt
from ..field.goldilocks import GF, batch_inv
from ..fri.oracle import COSET_SHIFT
from ..plonk.gates.base import BaseBatchCtx
from ..plonk.prover import _z_h_on_coset
from ..utils.bits import reverse_index_bits_perm
from .fri import ShardedMerkleTree
from .mesh import Mesh, all_gather, all_to_all, roll_left

P = gl64.ORDER_INT


def _lde_rows(blk: GF, rate_bits: int, shift: int, mesh: Mesh,
              from_coeffs: bool = False):
    """(coeffs, lde, bit-reversed rows) of the rank's polynomial block:
    coeffs and lde (b, N) are polynomial-sharded; the rows (b * size,
    N / size) hold every polynomial at the rank's block of bit-reversed
    LDE points."""
    coeffs = blk if from_coeffs else ntt.intt(blk)
    lde = ntt.lde(coeffs, rate_bits, shift=shift)
    n_big = lde.shape[-1]
    br = lde.take(reverse_index_bits_perm(n_big), axis=-1)
    return coeffs, lde, all_to_all(br.v, mesh)


def sharded_commitment(values: GF, rate_bits: int, shift: int,
                       cap_height: int, mesh: Mesh,
                       num_polys: int | None = None):
    """Commit a (num_polys, n) batch of subgroup evaluations.

    values: the rank's block of the batch (mesh.shard_polys); the zero pad
    rows at and above num_polys are dropped before leaf hashing.  Returns
    (cap, leaves): the MerkleCap (the same on every rank) and the rank's
    block of the (N, num_polys) leaf matrix in bit-reversed row order:
    rows [rank * N / size, (rank + 1) * N / size), N = n << rate_bits.
    """
    _, _, rows = _lde_rows(values, rate_bits, shift, mesh)
    if num_polys is not None:
        rows = rows[:num_polys]
    leaves = GF(rows.transpose(0, 1).contiguous())
    tree = ShardedMerkleTree(leaves, cap_height, mesh)
    return tree.cap, leaves


def _next_with_halo(blk: GF, next_step: int, mesh: Mesh) -> GF:
    """Global roll(-next_step) of a row-sharded (..., M / size) block."""
    return GF(roll_left(blk.v, next_step, mesh))


def _coset_block(degree_bits: int, qdb: int, mesh: Mesh):
    """(xs, Z_H(xs), 1/Z_H(xs)) on the rank's block of the quotient coset
    shift * H', |H'| = 2^(degree_bits + qdb), natural order: points
    [rank * M / size, (rank + 1) * M / size)."""
    m = 1 << (degree_bits + qdb)
    b = m // mesh.size
    lo = mesh.rank * b
    w = gl64.primitive_root_of_unity(degree_bits + qdb)
    start = gl64.pow_scalar(w, lo) * COSET_SHIFT % P
    xs = gl64.mul(gl64.powers(w, b), np.uint64(start))
    zh = _z_h_on_coset(degree_bits, qdb)                 # period 2^qdb
    period = len(zh)
    reps = np.arange(lo, lo + b) % period
    return (GF.from_u64(xs, mesh.device), GF.from_u64(zh[reps], mesh.device),
            GF.from_u64(gl64.batch_inv(zh)[reps], mesh.device))


def sharded_stark_quotient_values(stark, trace_lde: GF, alphas,
                                  degree_bits: int, qdb: int, mesh: Mesh,
                                  public_inputs=(), perm_lde: GF = None,
                                  challenge_sets=None, config=None,
                                  num_perm_zs: int = None,
                                  ctl_zs_columns=None) -> GF:
    """Evaluate a STARK's alpha-folded constraint quotient on the coset,
    sharded by coset rows (the STARK analogue of plonk/prover.rs:576).

    trace_lde: the rank's block (COLUMNS, M / size) of the natural-order
    coset evaluations, M = n << qdb: points [rank * M / size, (rank + 1) *
    M / size).  perm_lde (optional): the same block of the permutation Z
    columns; their checks (starky permutation.rs:232) fold into the same
    accumulators.

    Multi-table mode (the sharded twin of stark/multi.py's quotient): when
    ctl_zs_columns is given, perm_lde carries both permutation and CTL Z
    rows: the first num_perm_zs are permutation Zs, the others pair with
    ctl_zs_columns and their running-product checks
    (cross_table_lookup.rs:374) fold into the same accumulators.
    Returns the rank's block (num_challenges, M / size) of the quotient
    values.
    """
    from ..stark.stark import ConstraintConsumer, StarkEvaluationVars

    n = 1 << degree_bits
    next_step = 1 << qdb
    last = pow(gl64.primitive_root_of_unity(degree_bits), P - 2, P)
    xs, zh, zh_inv = _coset_block(degree_bits, qdb, mesh)

    trace_next = _next_with_halo(trace_lde, next_step, mesh)
    z_last = xs - last
    lag_first = zh * batch_inv((xs - 1) * n)
    lag_last = zh * batch_inv(z_last * n)
    ctx = BaseBatchCtx(mesh.device)
    vars = StarkEvaluationVars(
        local_values=[trace_lde[i] for i in range(stark.COLUMNS)],
        next_values=[trace_next[i] for i in range(stark.COLUMNS)],
        public_inputs=[ctx.constant(int(pi)) for pi in public_inputs],
    )
    consumer = ConstraintConsumer(ctx, [int(a) for a in alphas], z_last,
                                  lag_first, lag_last)
    stark.eval_generic(ctx, vars, consumer)
    if perm_lde is not None:
        zs_next = _next_with_halo(perm_lde, next_step, mesh)
        n_perm = perm_lde.shape[0] if num_perm_zs is None else num_perm_zs
        if n_perm:
            from ..stark.permutation import eval_permutation_checks
            eval_permutation_checks(
                ctx, stark, config, vars,
                [perm_lde[i] for i in range(n_perm)],
                [zs_next[i] for i in range(n_perm)],
                challenge_sets, consumer)
        if ctl_zs_columns is not None:
            from ..stark.ctl import (CtlCheckVars,
                                     eval_cross_table_lookup_checks)
            ctl_vars = [
                CtlCheckVars(perm_lde[n_perm + i], zs_next[n_perm + i],
                             zc.challenge, zc.columns, zc.filter_column)
                for i, zc in enumerate(ctl_zs_columns)]
            eval_cross_table_lookup_checks(ctx, vars, ctl_vars, consumer)
    return GF.stack([acc * zh_inv for acc in consumer.accumulators()], axis=0)


def gather_rows(blk: GF, mesh: Mesh) -> GF:
    """The whole (k, M) matrix from each rank's (k, M / size) block."""
    return GF(all_gather(blk.v, mesh, axis=1))
