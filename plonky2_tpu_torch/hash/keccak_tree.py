"""Keccak-256 hasher backend: byte-digest Merkle trees + the challenger
permutation of KeccakGoldilocksConfig.

Twin of reference plonky2/src/hash/keccak.rs:22-127 (KeccakHash<25> +
KeccakPermutation) and the BytesHash plumbing (hash_types.rs:158-192).
The reference offers this config for cheap non-recursive proofs (keccak
beats Poseidon on scalar CPUs; only algebraic hashers can recurse,
config.rs:124).  Hashing runs on the host: keccak.cpp through ctypes
(native/) when it builds, else batched numpy keccak-f over u64 lanes
(hash/keccak.py keccak_f, one vectorised pass per 136-byte block over all
rows); both give the same bytes.  Digests are (..., 25) uint8 arrays.  A
tree's leaves may come from the device (the LDE stays there); only their
rows are copied to the host to be hashed.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..field import gl64
from .keccak import HASH_SIZE, keccak_f

_RATE_BYTES = 136
_RATE_LANES = 17


def _absorb_blocks(byte_rows: np.ndarray) -> np.ndarray:
    """keccak256 of each row of a (n, L) uint8 matrix -> (n, 32) uint8.
    Pre-NIST padding (0x01 … 0x80), all rows same length => one batched
    keccak-f per block.  Dispatches to the C++ backend (native/keccak.cpp)
    when built; the numpy path below is the fallback + cross-check."""
    if native.available():
        return native.keccak256_rows(np.ascontiguousarray(byte_rows))
    n, length = byte_rows.shape
    blocks = length // _RATE_BYTES + 1
    padded = np.zeros((n, blocks * _RATE_BYTES), dtype=np.uint8)
    padded[:, :length] = byte_rows
    padded[:, length] ^= 0x01
    padded[:, -1] ^= 0x80
    lanes = padded.reshape(n, blocks, _RATE_BYTES // 8, 8).copy().view("<u8")
    lanes = lanes.reshape(n, blocks, _RATE_LANES).astype(np.uint64)
    state = np.zeros((n, 5, 5), dtype=np.uint64)
    flat = state.reshape(n, 25)
    for t in range(blocks):
        flat[:, :_RATE_LANES] ^= lanes[:, t]
        state = keccak_f(state)
        flat = state.reshape(n, 25)
    out = flat[:, :4].astype("<u8")
    return out.view(np.uint8).reshape(n, 32)


def _felt_rows_to_bytes(felts: np.ndarray) -> np.ndarray:
    """(n, k) u64 felts -> (n, 8k) uint8, canonical LE (keccak.rs:111)."""
    canon = gl64.to_canonical(np.asarray(felts, dtype=np.uint64))
    return canon.astype("<u8").view(np.uint8).reshape(canon.shape[0], -1)


def keccak_hash_or_noop(felts: np.ndarray, size: int = HASH_SIZE) -> np.ndarray:
    """(n, k) felt rows -> (n, size) byte digests.  Rows of <= size//8
    felts are stored raw, zero-padded (plonk/config.rs:55 hash_or_noop)."""
    felts = np.asarray(felts, dtype=np.uint64)
    n, k = felts.shape
    if 8 * k <= size:
        out = np.zeros((n, size), dtype=np.uint8)
        out[:, : 8 * k] = _felt_rows_to_bytes(felts)
        return out
    return _absorb_blocks(_felt_rows_to_bytes(felts))[:, :size]


def keccak_two_to_one(left: np.ndarray, right: np.ndarray,
                      size: int = HASH_SIZE) -> np.ndarray:
    """(n, size) x (n, size) byte digests -> (n, size) (keccak.rs:120)."""
    cat = np.concatenate([left, right], axis=1)
    return _absorb_blocks(cat)[:, :size]


def bytes_hash_to_felts(digests: np.ndarray) -> np.ndarray:
    """BytesHash::to_vec (hash_types.rs:181): 7-byte LE chunks -> felts
    (8-byte chunks would allow non-canonical collisions).
    (n, size) uint8 -> (n, ceil(size/7)) u64."""
    digests = np.atleast_2d(np.asarray(digests, dtype=np.uint8))
    n, size = digests.shape
    chunks = -(-size // 7)
    padded = np.zeros((n, chunks * 7), dtype=np.uint8)
    padded[:, :size] = digests
    out = np.zeros((n, chunks), dtype=np.uint64)
    for b in range(7):
        out |= padded[:, b::7].astype(np.uint64) << np.uint64(8 * b)
    return out


def keccak_permutation_np(state: np.ndarray) -> np.ndarray:
    """The challenger 'permutation' (keccak.rs:64-97): hash-onion over the
    96-byte state, u64 words rejection-sampled into 12 felts."""
    buf = gl64.to_canonical(np.asarray(state, dtype=np.uint64)).astype(
        "<u8").tobytes()
    out = []
    from .keccak import keccak256
    while len(out) < 12:
        buf = keccak256(buf)
        for i in range(4):
            w = int.from_bytes(buf[8 * i: 8 * i + 8], "little")
            if w < gl64.ORDER_INT:
                out.append(w)
    return np.array(out[:12], dtype=np.uint64)


class BytesMerkleCap:
    """MerkleCap over byte digests (reference MerkleCap<F, KeccakHash>)."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, dtype=np.uint8)  # (2^h, size)

    def flatten(self) -> np.ndarray:
        """Felt view for transcript observation (to_vec per digest)."""
        return bytes_hash_to_felts(self.data).reshape(-1)

    def __eq__(self, other) -> bool:
        return isinstance(other, BytesMerkleCap) and np.array_equal(
            self.data, other.data)


class BytesMerkleTree:
    """Merkle tree with 25-byte keccak digests; same interface as the
    Poseidon MerkleTree (hash/merkle.py) so the FRI prover can use either."""

    def __init__(self, leaves, cap_height: int):
        from ..utils.bits import log2_strict
        leaves_np = np.asarray(leaves.to_u64() if hasattr(leaves, "to_u64")
                               else leaves, dtype=np.uint64)
        n = leaves_np.shape[0]
        bits = log2_strict(n)
        assert cap_height <= bits
        self.cap_height = cap_height
        self.leaf_len = leaves_np.shape[1]
        self.leaves_np = leaves_np
        digests = keccak_hash_or_noop(leaves_np)
        levels = [digests]
        cur = digests
        for _ in range(bits - cap_height):
            cur = keccak_two_to_one(cur[0::2], cur[1::2])
            levels.append(cur)
        self.levels = levels
        self.cap = BytesMerkleCap(levels[-1])

    def open(self, indices: np.ndarray):
        """(q,) leaf indices -> (leaves (q, leaf_len) u64, sibs (q, depth,
        size) uint8), the batched form of ``get_leaf`` + ``prove``."""
        idx = np.asarray(indices, np.int64)
        depth = len(self.levels) - 1
        sibs = np.empty((len(idx), depth, HASH_SIZE), dtype=np.uint8)
        for lvl in range(depth):
            sibs[:, lvl] = self.levels[lvl][(idx >> lvl) ^ 1]
        return self.leaves_np[idx].copy(), sibs

    def prove(self, leaf_index: int):
        from .merkle import MerkleProof
        depth = len(self.levels) - 1
        sibs = np.empty((depth, HASH_SIZE), dtype=np.uint8)
        idx = leaf_index
        for lvl in range(depth):
            sibs[lvl] = self.levels[lvl][idx ^ 1]
            idx >>= 1
        return MerkleProof(sibs)

    def get_leaf(self, leaf_index: int) -> np.ndarray:
        return self.leaves_np[leaf_index]


def verify_bytes_merkle_proofs_to_cap(leaves: np.ndarray, indices: np.ndarray,
                                      cap: BytesMerkleCap,
                                      siblings: np.ndarray) -> bool:
    """q proofs into one byte cap at once: leaves (q, L) u64, indices (q,),
    siblings (q, depth, size) uint8; one batched 2-to-1 hash per level."""
    current = keccak_hash_or_noop(np.asarray(leaves, dtype=np.uint64))
    idx = np.asarray(indices, dtype=np.int64)
    siblings = np.asarray(siblings, dtype=np.uint8)
    for d in range(siblings.shape[1]):
        right = (idx & 1).astype(bool)[:, None]
        sib = siblings[:, d]
        current = keccak_two_to_one(np.where(right, sib, current),
                                    np.where(right, current, sib))
        idx = idx >> 1
    return bool(np.array_equal(current, cap.data[idx]))


def verify_bytes_merkle_proof_to_cap(leaf_data, leaf_index: int,
                                     cap: BytesMerkleCap, proof) -> bool:
    siblings = np.asarray(proof.siblings, dtype=np.uint8)
    return verify_bytes_merkle_proofs_to_cap(
        np.asarray(leaf_data, dtype=np.uint64)[None, :],
        np.array([leaf_index]), cap, siblings[None])
