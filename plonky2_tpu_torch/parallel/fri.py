"""Sharded FRI commit phase: the beta-folds and per-round Merkle commits
distributed over the mesh, and a Merkle tree whose lower levels stay on
their ranks.

Twin of the JAX package's parallel/fri.py (a redesign of reference
fri/prover.rs:69-113).  The reference folds in coefficient space (strided
beta-reduction, then a fresh coset FFT per round); that formulation needs
a global transpose-like resharding every round.  Here the fold runs in the
value domain on bit-reversed-ordered rows, where it is purely local:

  * in BR order, the arity-2^a fold coset of a value sits in the same
    contiguous 2^a-row chunk that becomes its Merkle leaf (that is why the
    reference flattens BR-adjacent chunks into leaves, oracle.rs:81-100);
  * an arity-2^a beta-fold equals a radix-2 value folds with beta^(2^j):
      fold_j(v)[m] = (v[2m] + v[2m+1])/2 + beta_j * (v[2m] - v[2m+1])/(2 x_m)
    with x_m = shift * w^rev(m) the subgroup point of BR pair m: adjacent
    rows, so each rank folds its block with no communication;
  * the folded layer lands already in BR contiguous order, sharded exactly
    like its parent: no resharding between rounds.

Communication per round: one all_gather of the last local digest level
(at most size * 2^cap_height digests).  The host challenger on every rank
interleaves between the rounds as in the single-device path, so caps,
betas and the final polynomial are those of fri/prover.py
fri_committed_trees.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import gl64, ntt
from ..field.extension import GF2
from ..field.goldilocks import GF
from ..fri.proof import FriProof
from ..fri.prover import (_flatten_ext_leaves, fri_proof_of_work,
                          fri_prover_query_rounds)
from ..hash.hashing import compress, compress_np, hash_or_noop
from ..hash.merkle import MerkleCap, MerkleProof
from ..iop.challenger import Challenger
from ..utils.bits import log2_strict, reverse_index_bits_perm
from .mesh import Mesh, all_gather

P = gl64.ORDER_INT


class ShardedMerkleTree:
    """A Merkle tree whose leaves and lower digest levels stay on their
    ranks (reference fri/prover.rs:160-216 reads openings out of host
    Vecs; here the host sees num_queries * depth digests, not 2^n rows).

    Rank r holds rows [r * L, (r + 1) * L) of the leaves and the matching
    rows of each local level (L = leaves / size); the levels above them
    (at most size * 2^cap_height digests) are host arrays on every rank.
    Same cap / cap_height / open / prove / get_leaf surface as
    hash.merkle.MerkleTree; ``open`` gathers every query's rows of every
    level with one all_gather.
    """

    def __init__(self, leaves: GF, cap_height: int, mesh: Mesh):
        nd = mesh.size
        local_rows = leaves.shape[0]
        bits = log2_strict(local_rows * nd)
        if cap_height > bits:
            raise ValueError(f"cap height {cap_height} exceeds tree height {bits}")
        local_levels = min(bits - cap_height, log2_strict(local_rows))
        cur = hash_or_noop(leaves)
        levels = [cur]
        for _ in range(local_levels):
            cur = compress(cur[0::2, :], cur[1::2, :])
            levels.append(cur)
        top_np = GF(all_gather(cur.v, mesh)).to_u64()
        top = []
        for _ in range((bits - cap_height) - local_levels):
            top_np = compress_np(top_np[0::2], top_np[1::2])
            top.append(top_np)
        self.cap_height = cap_height
        self.leaf_len = leaves.shape[1]
        self.mesh = mesh
        self.leaves = leaves
        self.levels = levels      # local: leaf digests up to the last local
        self.top = top            # host levels above them, cap last
        self.cap = MerkleCap(top_np)
        self.depth = len(levels) - 1 + len(top)   # sibling path below the cap

    def open(self, indices: np.ndarray):
        """(q,) leaf indices -> (leaves (q, leaf_len), sibs (q, depth, 4)),
        canonical host u64, with one all_gather for all local levels."""
        idx = np.asarray(indices, np.int64)
        q = idx.size
        nloc = min(len(self.levels), self.depth)
        # per local level: the row each query needs, and its owner
        wants = [(self.leaves, idx)] + [
            (self.levels[lvl], (idx >> lvl) ^ 1) for lvl in range(nloc)]
        parts = []
        owners = []
        for arr, rows in wants:
            local = arr.shape[0]
            owner = rows // local
            pick = torch.as_tensor(rows % local, device=arr.device)
            mine = torch.as_tensor(owner == self.mesh.rank, device=arr.device)
            vals = torch.where(mine[:, None], arr.v[pick],
                               torch.zeros((), dtype=torch.int64,
                                           device=arr.device))
            parts.append(vals)
            owners.append(owner)
        local = torch.cat(parts, dim=1)                    # (q, width)
        everyone = all_gather(local.unsqueeze(0), self.mesh)
        widths = [p.shape[1] for p in parts]
        cols = np.cumsum([0] + widths)
        out = []
        for j, owner in enumerate(owners):
            sel = everyone[torch.as_tensor(owner, device=everyone.device),
                           torch.arange(q, device=everyone.device),
                           cols[j]:cols[j + 1]]
            out.append(GF(sel).to_u64())
        leaves = out[0]
        sibs = np.empty((q, self.depth, 4), dtype=np.uint64)
        for lvl in range(self.depth):
            if lvl < nloc:
                sibs[:, lvl] = out[1 + lvl]
            else:
                sibs[:, lvl] = self.top[lvl - len(self.levels)][(idx >> lvl) ^ 1]
        return leaves, sibs

    def prove(self, leaf_index: int) -> MerkleProof:
        _, sibs = self.open(np.array([leaf_index]))
        return MerkleProof(sibs[0])

    def get_leaf(self, leaf_index: int) -> np.ndarray:
        leaves, _ = self.open(np.array([leaf_index]))
        return leaves[0]


@lru_cache(maxsize=64)
def _fold_tables(log_n: int, shift: int, arity_bits: int) -> tuple:
    """Per-stage 1/(2 x_m) tables for the radix-2 value folds of one round.

    Stage j folds a layer of size 2^(log_n - j) with coset shift^(2^j);
    x_m = shift_j * w_j^rev(m), so inv2x[m] = (2 x_m)^-1 =
    inv(2 shift_j) * w_j^-rev(m): one vectorised powers() and a
    bit-reversal gather, no per-row host loop."""
    tables = []
    s = shift % P
    for j in range(arity_bits):
        half = 1 << (log_n - j - 1)
        w_inv = pow(gl64.primitive_root_of_unity(log_n - j), P - 2, P)
        inv2s = pow(2 * s % P, P - 2, P)
        nat = gl64.mul(np.uint64(inv2s), gl64.powers(w_inv, half))
        tables.append(nat[reverse_index_bits_perm(half)])
        s = s * s % P
    return tuple(tables)


def _fold(v: GF2, betas: list, tables: list) -> GF2:
    """arity_bits local radix-2 value folds of a BR-ordered block."""
    inv2 = pow(2, P - 2, P)
    for beta, tab in zip(betas, tables):
        even, odd = v[0::2], v[1::2]
        half_sum = GF2((even.a + odd.a) * inv2, (even.b + odd.b) * inv2)
        v = half_sum + (even - odd) * tab * beta   # tab carries the 1/2
    return v


def sharded_fri_committed_trees(values: GF2, challenger: Challenger,
                                fri_params, mesh: Mesh):
    """Distributed commit phase, value-identical to fri_committed_trees.

    values: the (n,) extension values of the composition polynomial over
    the shifted LDE coset, natural order, on the rank's device (every rank
    passes the same).
    Returns (trees, final_coeffs): ShardedMerkleTrees (rank r holds rows
    [r * m / size, (r + 1) * m / size) of each m-leaf layer) and the final
    polynomial's coefficients as host u64 (keep, 2).
    """
    nd = mesh.size
    n = values.shape[0]
    cap_height = fri_params.config.cap_height
    shift = gl64.MULTIPLICATIVE_GROUP_GENERATOR

    # one global bit-reversal up front; every later layer stays BR-ordered
    b = n // nd
    perm = reverse_index_bits_perm(n)[mesh.rank * b:(mesh.rank + 1) * b]
    blk = values.take(perm, axis=0)

    trees = []
    for arity_bits in fri_params.reduction_arity_bits:
        arity = 1 << arity_bits
        if n // arity < nd:
            raise ValueError("the mesh out-numbers the layer's leaves")
        tree = ShardedMerkleTree(_flatten_ext_leaves(blk, arity), cap_height,
                                 mesh)
        trees.append(tree)
        challenger.observe_cap(tree.cap)
        beta_np = challenger.get_extension_challenge()

        # beta^(2^j) for the radix-2 stages, and each stage's table block
        beta = GF2.from_u64_pair(beta_np[0], beta_np[1], mesh.device)
        betas = []
        for _ in range(arity_bits):
            betas.append(beta)
            beta = beta.square()
        tables = []
        for j, tab in enumerate(_fold_tables(log2_strict(n), shift,
                                             arity_bits)):
            tb = tab.shape[0] // nd
            tables.append(GF.from_u64(tab[mesh.rank * tb:(mesh.rank + 1) * tb],
                                      mesh.device))
        blk = _fold(blk, betas, tables)
        n //= arity
        shift = pow(shift, arity, P)

    # final polynomial: gather the (small) remaining values and recover the
    # coefficients with one coset interpolation
    vals = GF2(GF(all_gather(blk.a.v, mesh)), GF(all_gather(blk.b.v, mesh)))
    vals = vals.take(reverse_index_bits_perm(n), axis=0)
    coeffs = ntt.coset_intt_ext(vals, shift)
    final_coeffs = coeffs[:n >> fri_params.config.rate_bits].to_u64()
    for c in final_coeffs:
        challenger.observe_extension_element(c)
    return trees, final_coeffs


def sharded_fri_proof(initial_merkle_trees: list, values: GF2,
                      challenger: Challenger, fri_params,
                      mesh: Mesh) -> FriProof:
    """Distributed FRI proof, byte-identical to fri/prover.py fri_proof
    (reference fri/prover.rs:20-216): the sharded commit phase, the
    proof-of-work grind (every rank grinds the same candidates on its
    device, so the transcript stays replicated), and the query rounds,
    whose indices are drawn first and which open each tree once for all
    rounds (one all_gather per tree).  The codeword and every folded layer
    stay on their ranks; the host receives only the opened rows.
    initial_merkle_trees are ShardedMerkleTrees.
    """
    n = values.shape[0]
    trees, final_coeffs = sharded_fri_committed_trees(values, challenger,
                                                      fri_params, mesh)
    pow_witness = fri_proof_of_work(challenger, fri_params.config,
                                    mesh.device)
    rounds = fri_prover_query_rounds(initial_merkle_trees, trees, challenger,
                                     n, fri_params)
    return FriProof(
        commit_phase_merkle_caps=[t.cap for t in trees],
        query_round_proofs=rounds,
        final_poly=final_coeffs,
        pow_witness=pow_witness,
    )
