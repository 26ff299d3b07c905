"""STARK permutation argument (twin of reference starky/src/permutation.rs).

Column pairs claimed to be permutations of one another are checked with
randomized grand products: per batch of (pair, challenge) instances one Z
column carries the running product of
    prod_i (gamma + sum_j beta^j lhs_j) / (gamma + sum_j beta^j rhs_j).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field.goldilocks import GF, batch_inv
from ..plonk.prover import _exclusive_prefix_product


@dataclass(frozen=True)
class PermutationPair:
    """Pairs of columns claimed to be permutations (permutation.rs:30)."""

    column_pairs: tuple

    @staticmethod
    def singletons(lhs: int, rhs: int) -> "PermutationPair":
        return PermutationPair(((lhs, rhs),))


def get_n_permutation_challenge_sets(challenger, num_challenges: int,
                                     num_sets: int) -> list:
    """num_sets sets of num_challenges (beta, gamma) pairs
    (permutation.rs:170)."""
    return [[(challenger.get_challenge(), challenger.get_challenge())
             for _ in range(num_challenges)] for _ in range(num_sets)]


def get_permutation_batches(pairs: list, challenge_sets: list,
                            num_challenges: int, batch_size: int) -> list:
    """Chunk the (pair x challenge) product; instance i in a batch uses
    challenge_sets[i] (permutation.rs:228)."""
    items = [(pair, chal) for pair in pairs for chal in range(num_challenges)]
    batches = []
    for start in range(0, len(items), batch_size):
        chunk = items[start:start + batch_size]
        batches.append([(pair, challenge_sets[i][chal])
                        for i, (pair, chal) in enumerate(chunk)])
    return batches


def num_permutation_batches(stark, config) -> int:
    n = len(stark.permutation_pairs()) * config.num_challenges
    return -(-n // stark.permutation_batch_size())


def compute_permutation_z_polys_gf(stark, config, trace: GF,
                                   challenge_sets: list) -> GF:
    """(num_batches, n) Z columns from the device trace (COLUMNS, n):
    quotients of the randomized products, then an exclusive prefix product
    along the rows (permutation.rs:66).  Every batch's denominators share
    one batch inversion and every Z one scan, so the launch count does not
    grow with the number of batches."""
    device = trace.device
    batches = get_permutation_batches(
        stark.permutation_pairs(), challenge_sets, config.num_challenges,
        stark.permutation_batch_size())
    numers = []
    denoms = []
    for batch in batches:
        numer = None
        denom = None
        for pair, (beta, gamma) in batch:
            rl = GF.full((), int(gamma), device)
            rr = rl
            w = GF.ones((), device)
            for (l, r) in pair.column_pairs:
                rl = rl + trace[l] * w
                rr = rr + trace[r] * w
                w = w * int(beta)
            numer = rl if numer is None else numer * rl
            denom = rr if denom is None else denom * rr
        numers.append(numer)
        denoms.append(denom)
    quotients = GF.stack(numers, axis=0) * batch_inv(GF.stack(denoms, axis=0))
    return _exclusive_prefix_product(quotients)


def eval_permutation_checks(ctx, stark, config, vars, local_zs, next_zs,
                            challenge_sets, consumer) -> None:
    """Z(1)=1 plus the per-batch transition Z(gx)*prod(rhs) = Z(x)*prod(lhs)
    (permutation.rs:262).  Challenges may be host ints or field elements."""
    def elem(v):
        return ctx.constant(int(v)) if isinstance(v, (int, np.integer)) else v

    for z in local_zs:
        consumer.constraint_first_row(z - ctx.one())

    batches = get_permutation_batches(
        stark.permutation_pairs(), challenge_sets, config.num_challenges,
        stark.permutation_batch_size())
    for i, batch in enumerate(batches):
        lhs_prod = None
        rhs_prod = None
        for pair, (beta, gamma) in batch:
            beta_e, gamma_e = elem(beta), elem(gamma)
            rl = gamma_e
            rr = gamma_e
            wpow = None  # beta^0 handled by plain add
            for (l, r) in pair.column_pairs:
                lv = vars.local_values[l]
                rv = vars.local_values[r]
                if wpow is None:
                    rl = rl + lv
                    rr = rr + rv
                    wpow = beta_e
                else:
                    rl = rl + lv * wpow
                    rr = rr + rv * wpow
                    wpow = wpow * beta_e
            lhs_prod = rl if lhs_prod is None else lhs_prod * rl
            rhs_prod = rr if rhs_prod is None else rhs_prod * rr
        consumer.constraint(next_zs[i] * rhs_prod - local_zs[i] * lhs_prod)
