"""PolynomialBatch: the batch FRI polynomial commitment (oracle).

Twin of reference fri/oracle.rs:43-220.  Commit: iNTT of the value rows,
coset LDE (the CUDA kernels on the card), plus SALT_SIZE random rows when
blinding, and a Merkle tree whose leaf i is column reverse_bits(i) of that
(k, N) array: level-batched Poseidon on the device, the leaves hashed where
the LDE lies (MerkleTree.from_columns, no transposed copy), or, under the
keccak config, a keccak byte-digest tree hashed on the host
(hash/keccak_tree.py) over the LDE's leaf rows.
``prove_openings`` builds the FRI composition polynomial with alpha powers
and divides (F(X) - F(z)) / (X - z) in the value domain over the coset
(one batch inversion + coset iNTT) instead of the reference's sequential
synthetic division: the same quotient, computed in parallel.
"""

from __future__ import annotations

import os

import numpy as np

from ..field import gl64, ntt
from ..field.extension import GF2
from ..field.goldilocks import GF, batch_inv
from ..field.polynomial import eval_ext_polys_at_ext, powers_ext
from ..hash.keccak_tree import BytesMerkleTree
from ..hash.merkle import MerkleTree
from ..iop.challenger import Challenger
from ..utils.bits import log2_strict, reverse_index_bits_perm
from ..utils.timing import TimingTree
from .config import FriParams
from .proof import FriProof
from .prover import fri_proof
from .structure import FriInstanceInfo

SALT_SIZE = 4
COSET_SHIFT = gl64.MULTIPLICATIVE_GROUP_GENERATOR  # F::coset_shift() = 7


def batch_opening_quotient(comp: GF2, z: GF2, n: int, subgroup: GF) -> GF2:
    """Coefficients of (F(X) - F(z)) / (X - z) for one opening batch, by
    division in the value domain over the coset gH (not H: opening points
    may lie in H)."""
    comp_vals = ntt.coset_ntt_ext(comp, COSET_SHIFT)
    fz = eval_ext_polys_at_ext(comp, powers_ext(z, n))
    num = comp_vals - fz.broadcast_to((n,))
    # 1/(x - z) for base x: conj/norm with one base batch inversion
    xa = subgroup * COSET_SHIFT - z.a.broadcast_to((n,))
    zb = z.b.broadcast_to((n,))
    norm = xa.square() - zb.square().mul_small(7)
    ninv = batch_inv(norm)
    den_inv = GF2(xa * ninv, zb * ninv)
    return ntt.coset_intt_ext(num * den_inv, COSET_SHIFT)


class PolynomialBatch:
    """A batch of committed polynomials: coefficients on the device, their
    natural-order LDE values, and the Merkle tree of the LDE rows."""

    def __init__(self, polynomials: GF, lde_values: GF, merkle_tree,
                 degree_log: int, rate_bits: int, blinding: bool,
                 hasher: str = "poseidon"):
        self.polynomials = polynomials   # (num_polys, n) coefficient rows
        self.lde_values = lde_values     # (num_polys, n << rate_bits)
        self.merkle_tree = merkle_tree
        self.degree_log = degree_log
        self.rate_bits = rate_bits
        self.blinding = blinding
        self.hasher = hasher

    @classmethod
    def from_values(cls, values: GF, rate_bits: int, blinding: bool,
                    cap_height: int,
                    hasher: str = "poseidon") -> "PolynomialBatch":
        """values: (num_polys, n) evaluations over the subgroup."""
        return cls.from_coeffs(ntt.intt(values), rate_bits, blinding,
                               cap_height, hasher)

    @classmethod
    def from_coeffs(cls, polynomials: GF, rate_bits: int, blinding: bool,
                    cap_height: int,
                    hasher: str = "poseidon") -> "PolynomialBatch":
        n = polynomials.shape[-1]
        k = polynomials.shape[0]
        lde_values = ntt.lde(polynomials, rate_bits, shift=COSET_SHIFT)
        leaf_cols = lde_values
        if blinding:
            # SALT_SIZE random columns so leaf openings reveal nothing about
            # the committed values (fri/oracle.rs:109-126).  Salts must be
            # unpredictable, so they come from the OS CSPRNG, reduced mod p
            # (a bias within 2^-32, as Field::sample).
            count = SALT_SIZE * (n << rate_bits)
            raw = np.frombuffer(os.urandom(8 * count), dtype=np.uint64)
            salt = GF.from_u64(gl64.to_canonical(raw).reshape(
                SALT_SIZE, n << rate_bits), polynomials.device)
            leaf_cols = GF.concatenate([lde_values, salt], axis=0)
            lde_values = leaf_cols[:k]        # a view: one copy of the LDE
        # columns of the evaluation matrix become Merkle leaves, in
        # bit-reversed order (reference fri/oracle.rs:81-100)
        if hasher == "keccak":
            perm = reverse_index_bits_perm(n << rate_bits)
            tree = BytesMerkleTree(leaf_cols.transpose(1, 0).take(perm, axis=0),
                                   cap_height)
        else:
            tree = MerkleTree.from_columns(leaf_cols, cap_height)
        return cls(polynomials, lde_values, tree, log2_strict(n), rate_bits,
                   blinding, hasher)

    def lde_values_natural(self) -> GF:
        """(num_polys, n << rate_bits) evaluations in natural coset order."""
        return self.lde_values

    # -- batch opening proof (reference fri/oracle.rs:162) -------------------
    @staticmethod
    def prove_openings(instance: FriInstanceInfo, oracles: list,
                       challenger: Challenger, fri_params: FriParams,
                       timing: TimingTree) -> FriProof:
        device = oracles[0].polynomials.device
        alpha_np = challenger.get_extension_challenge()
        alpha = GF2.from_u64_pair(alpha_np[0], alpha_np[1], device)
        n = 1 << fri_params.degree_bits
        # final_poly = sum_i alpha^(k_i) (F_i(X) - F_i(z_i)) / (X - z_i),
        # F_i = sum_j alpha^j f_ij (ReducingFactor's count/shift bookkeeping)
        final_poly = None
        subgroup = GF.from_u64(gl64.two_adic_subgroup(fri_params.degree_bits),
                               device)
        with timing.scope("alpha composition + opening quotients"):
            for batch in instance.batches:
                k = len(batch.polynomials)
                polys = GF.stack(
                    [oracles[p.oracle_index].polynomials[p.polynomial_index]
                     for p in batch.polynomials], axis=0)   # (k, n)
                apow = powers_ext(alpha, k)
                comp = GF2((polys * apow.a.reshape(-1, 1)).sum(axis=0),
                           (polys * apow.b.reshape(-1, 1)).sum(axis=0))
                z = GF2.from_u64_pair(batch.point[0], batch.point[1], device)
                quotient = batch_opening_quotient(comp, z, n, subgroup)
                if final_poly is None:
                    final_poly = quotient
                else:
                    final_poly = final_poly * alpha.pow_const(k) + quotient

        rate_bits = fri_params.config.rate_bits
        with timing.scope("final poly LDE"):
            pad = GF.zeros((((1 << rate_bits) - 1) * n,), device)
            lde_coeffs = GF2(GF.concatenate([final_poly.a, pad]),
                             GF.concatenate([final_poly.b, pad]))
            lde_values = ntt.lde_ext(final_poly, rate_bits, shift=COSET_SHIFT)

        return fri_proof([o.merkle_tree for o in oracles], lde_coeffs,
                         lde_values, challenger, fri_params, timing,
                         oracles[0].hasher)
