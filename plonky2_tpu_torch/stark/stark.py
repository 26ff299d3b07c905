"""The Stark (AIR) interface and constraint consumer.

Twin of reference starky/src/stark.rs:21 and constraint_consumer.rs:12.
An AIR is a constraint function over (local row, next row, public inputs),
written once against operator-polymorphic field elements: the prover calls
it with device GF arrays spanning the whole quotient coset, the verifier
with host E2 extension scalars at zeta (and, later, the recursive verifier
with circuit targets).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fri.structure import (FriBatchInfo, FriInstanceInfo, FriOracleInfo,
                             FriPolynomialInfo)
from ..field import gl64, gl64ext
import numpy as np


@dataclass
class StarkEvaluationVars:
    local_values: list
    next_values: list
    public_inputs: list


class ConstraintConsumer:
    """Accumulates alpha-weighted constraints (constraint_consumer.rs:12)."""

    def __init__(self, ctx, alphas, z_last, lagrange_basis_first,
                 lagrange_basis_last):
        self.ctx = ctx
        # alphas may be host ints (prover/verifier) or circuit elements
        # (recursive verifier)
        self.alphas = [ctx.constant(int(a)) if isinstance(a, (int, np.integer))
                       else a for a in alphas]
        self.accs = [ctx.zero() for _ in alphas]
        self.z_last = z_last
        self.lagrange_basis_first = lagrange_basis_first
        self.lagrange_basis_last = lagrange_basis_last

    def constraint(self, c) -> None:
        self.accs = [acc * a + c for acc, a in zip(self.accs, self.alphas)]

    def constraint_transition(self, c) -> None:
        self.constraint(c * self.z_last)

    def constraint_first_row(self, c) -> None:
        self.constraint(c * self.lagrange_basis_first)

    def constraint_last_row(self, c) -> None:
        self.constraint(c * self.lagrange_basis_last)

    def accumulators(self) -> list:
        return self.accs


class Stark:
    """Base AIR: subclasses set COLUMNS / PUBLIC_INPUTS and implement
    eval_generic + constraint_degree."""

    COLUMNS: int = 0
    PUBLIC_INPUTS: int = 0

    def eval_generic(self, ctx, vars: StarkEvaluationVars,
                     yield_constr: ConstraintConsumer) -> None:
        raise NotImplementedError

    def constraint_degree(self) -> int:
        raise NotImplementedError

    def quotient_degree_factor(self) -> int:
        return max(1, self.constraint_degree() - 1)

    def num_quotient_polys(self, config) -> int:
        return self.quotient_degree_factor() * config.num_challenges

    def permutation_pairs(self) -> list:
        """PermutationPair list (stark.rs:195)."""
        return []

    def uses_permutation_args(self) -> bool:
        return bool(self.permutation_pairs())

    def permutation_batch_size(self) -> int:
        """Products in the Z transition have batch_size factors, so the batch
        size is the constraint degree minus one = quotient degree factor
        (stark.rs:204)."""
        return max(1, self.quotient_degree_factor())

    def num_permutation_batches(self, config) -> int:
        from .permutation import num_permutation_batches
        return num_permutation_batches(self, config)

    def fri_instance(self, zeta: np.ndarray, g: int, config) -> FriInstanceInfo:
        """(stark.rs:88) zeta batch: trace ++ (perm zs) ++ quotient;
        g*zeta batch: trace ++ (perm zs)."""
        oracles = [FriOracleInfo(self.COLUMNS, False)]
        trace_info = FriPolynomialInfo.from_range(0, 0, self.COLUMNS)
        perm_info = []
        if self.uses_permutation_args():
            num_zs = self.num_permutation_batches(config)
            perm_info = FriPolynomialInfo.from_range(len(oracles), 0, num_zs)
            oracles.append(FriOracleInfo(num_zs, False))
        num_quotient = self.num_quotient_polys(config)
        quotient_info = FriPolynomialInfo.from_range(len(oracles), 0, num_quotient)
        oracles.append(FriOracleInfo(num_quotient, False))
        zeta_next = gl64ext.scalar_mul(np.asarray(zeta, np.uint64), np.uint64(g))
        return FriInstanceInfo(
            oracles=oracles,
            batches=[
                FriBatchInfo(point=np.asarray(zeta, np.uint64),
                             polynomials=trace_info + perm_info + quotient_info),
                FriBatchInfo(point=zeta_next, polynomials=trace_info + perm_info),
            ],
        )
