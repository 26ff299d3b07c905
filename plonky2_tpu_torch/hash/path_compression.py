"""Merkle path compression across many openings of the same tree.

Twin of reference plonky2/src/hash/path_compression.rs: when several indices
of one tree are opened (FRI query rounds), sibling nodes shared between
paths — or derivable from other opened leaves — are stored once or not at
all. Used by CompressedProof.
"""

from __future__ import annotations

import numpy as np

from .hashing import compress_np, hash_or_noop_np
from .merkle import MerkleProof


def compress_merkle_proofs(cap_height: int, indices: list,
                           proofs: list) -> list:
    assert proofs
    height = cap_height + len(proofs[0].siblings)
    num_leaves = 1 << height
    known = np.zeros(2 * num_leaves, dtype=bool)
    for i in indices:
        for j in range(height - cap_height):
            known[(i + num_leaves) >> j] = True

    out = []
    for i, p in zip(indices, proofs):
        kept = []
        index = i + num_leaves
        for sibling in p.siblings:
            sib = index ^ 1
            if not known[sib]:
                kept.append(sibling)
                known[sib] = True
            index >>= 1
            known[index] = True
        out.append(MerkleProof(np.array(kept, dtype=np.uint64).reshape(-1, 4)))
    return out


def decompress_merkle_proofs(leaves_data: list, leaves_indices: list,
                             compressed_proofs: list, height: int,
                             cap_height: int) -> list:
    num_leaves = 1 << height
    seen: dict = {}
    for i, v in zip(leaves_indices, leaves_data):
        seen[i + num_leaves] = hash_or_noop_np(np.asarray(v, dtype=np.uint64))

    cursors = [iter(p.siblings) for p in compressed_proofs]
    for layer in range(height - cap_height):
        for i, cur in zip(leaves_indices, cursors):
            index = (i + num_leaves) >> layer
            current = seen[index]
            sib = index ^ 1
            if sib not in seen:
                seen[sib] = np.asarray(next(cur), dtype=np.uint64)
            if index % 2 == 0:
                parent = compress_np(current, seen[sib])
            else:
                parent = compress_np(seen[sib], current)
            seen[index >> 1] = parent

    out = []
    for i in leaves_indices:
        sibs = []
        index = i + num_leaves
        for _ in range(height - cap_height):
            sibs.append(seen[index ^ 1])
            index >>= 1
        out.append(MerkleProof(np.array(sibs, dtype=np.uint64).reshape(-1, 4)))
    return out
