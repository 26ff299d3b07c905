"""Merkle tree with cap, built level by level with batched Poseidon.

Twin of reference plonky2/src/hash/merkle_tree.rs:18-173, breadth first: one
batched ``hash_or_noop`` over all leaves, then log2(n) - cap_height batched
2-to-1 compressions, one permutation launch per level.  Digests, caps and
proofs equal the reference's.  Leaves and digest levels stay on the device;
only the cap is pulled to the host, and ``open`` gathers just the requested
rows of every level.  A tree built by ``from_columns`` keeps its leaves as
the (leaf_len, n) columns they were given (a committed batch's LDE, leaf i
being column reverse_bits(i)), hashed where they lie, and gathers an opened
leaf from them; ``leaves`` builds the (n, leaf_len) rows only when read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field.goldilocks import GF
from ..utils.bits import log2_strict, reverse_index_bits_perm
from .hashing import (compress, compress_np, hash_or_noop, hash_or_noop_cols,
                      hash_or_noop_np)


@dataclass
class MerkleCap:
    """The 2^cap_height roots (reference merkle_tree.rs:18)."""

    data: np.ndarray  # (2^cap_height, 4) u64

    def flatten(self) -> np.ndarray:
        return self.data.reshape(-1)

    @property
    def cap_height(self) -> int:
        return log2_strict(self.data.shape[0])

    def __eq__(self, other) -> bool:
        return isinstance(other, MerkleCap) and np.array_equal(self.data, other.data)


@dataclass
class MerkleProof:
    siblings: np.ndarray  # (depth, 4) u64


class MerkleTree:
    """leaves: GF (n, leaf_len) rows on the device; n a power of two."""

    def __init__(self, leaves: GF, cap_height: int):
        self._set_levels(hash_or_noop(leaves), cap_height)
        self.leaf_len = leaves.shape[1]
        self._rows, self.columns = leaves, None

    @classmethod
    def from_columns(cls, columns: GF, cap_height: int) -> "MerkleTree":
        """The tree of the leaves (leaf_len, n) columns hold, leaf i being
        column reverse_bits(i): hashed in place, no row copy kept."""
        tree = cls.__new__(cls)
        tree._set_levels(hash_or_noop_cols(columns), cap_height)
        tree.leaf_len = columns.shape[0]
        tree._rows, tree.columns = None, columns
        return tree

    @classmethod
    def from_levels(cls, levels: list, cap_height: int,
                    columns: GF) -> "MerkleTree":
        """The tree of from_columns(columns, cap_height) whose digest levels
        are known already (a checkpoint, a gathered commitment)."""
        tree = cls.__new__(cls)
        tree.cap_height = cap_height
        tree.leaf_len = columns.shape[0]
        tree.levels = levels
        tree.cap = MerkleCap(levels[-1].to_u64())
        tree._rows, tree.columns = None, columns
        return tree

    def _set_levels(self, digests: GF, cap_height: int) -> None:
        bits = log2_strict(digests.shape[0])
        if cap_height > bits:
            raise ValueError(f"cap height {cap_height} exceeds tree height {bits}")
        self.cap_height = cap_height
        cur = digests
        levels = [cur]
        for _ in range(bits - cap_height):
            cur = compress(cur[0::2, :], cur[1::2, :])
            levels.append(cur)
        self.levels = levels      # levels[0]: leaf digests; levels[-1]: cap
        self.cap = MerkleCap(levels[-1].to_u64())

    @property
    def leaves(self) -> GF:
        """(n, leaf_len) leaf rows in leaf order (from the columns, a new
        tensor on each read)."""
        if self.columns is None:
            return self._rows
        perm = reverse_index_bits_perm(self.columns.shape[1])
        return self.columns.transpose(1, 0).take(perm, axis=0)

    def open(self, indices: np.ndarray):
        """(q,) leaf indices -> (leaves (q, leaf_len), sibs (q, depth, 4)),
        canonical host u64, one gather per level."""
        idx_np = np.asarray(indices, np.int64)
        device = self.levels[0].device
        idx = torch.as_tensor(idx_np, device=device)
        depth = len(self.levels) - 1
        if self.columns is None:
            leaves = GF(self._rows.v[idx]).to_u64()
        else:
            perm = reverse_index_bits_perm(self.columns.shape[1])
            cols = torch.as_tensor(perm[idx_np].astype(np.int64), device=device)
            leaves = GF(self.columns.v[:, cols].transpose(0, 1)).to_u64()
        if depth == 0:
            return leaves, np.zeros((idx.numel(), 0, 4), np.uint64)
        sibs = GF(torch.stack([self.levels[d].v[(idx >> d) ^ 1]
                               for d in range(depth)], dim=1)).to_u64()
        return leaves, sibs

    def prove(self, leaf_index: int) -> MerkleProof:
        """Sibling path from leaf to cap (reference merkle_tree.rs:173)."""
        _, sibs = self.open(np.array([leaf_index]))
        return MerkleProof(sibs[0])

    def get_leaf(self, leaf_index: int) -> np.ndarray:
        leaves, _ = self.open(np.array([leaf_index]))
        return leaves[0]


def verify_merkle_proofs_to_cap(leaves: np.ndarray, indices: np.ndarray,
                                cap: MerkleCap, siblings: np.ndarray) -> bool:
    """Host verification of q proofs into one cap at once (reference
    hash/merkle_proofs.rs:54, batched): leaves (q, L), indices (q,),
    siblings (q, depth, 4); one batched compress per level."""
    current = hash_or_noop_np(np.asarray(leaves, dtype=np.uint64))
    idx = np.asarray(indices, dtype=np.int64)
    siblings = np.asarray(siblings, dtype=np.uint64)
    for d in range(siblings.shape[1]):
        right = (idx & 1).astype(bool)[:, None]
        sib = siblings[:, d]
        current = compress_np(np.where(right, sib, current),
                              np.where(right, current, sib))
        idx = idx >> 1
    return bool(np.array_equal(current, cap.data[idx]))


def verify_merkle_proof_to_cap(leaf_data: np.ndarray, leaf_index: int,
                               cap: MerkleCap, proof: MerkleProof) -> bool:
    """Host verification of one proof (reference hash/merkle_proofs.rs:54)."""
    return verify_merkle_proofs_to_cap(
        np.asarray(leaf_data, dtype=np.uint64)[None], np.array([leaf_index]),
        cap, np.asarray(proof.siblings, dtype=np.uint64).reshape(1, -1, 4))
