"""Keccak-256 and the KeccakHash field-element hasher.

Twin of reference plonky2/src/hash/keccak.rs:22-104: the non-algebraic
hasher used for cheap non-recursive proof configs (KeccakGoldilocksConfig).
keccak-f[1600] is implemented on numpy uint64 lanes (batch-friendly; the
same round function a future keccak STARK table evaluates).
"""

from __future__ import annotations

import numpy as np

from ..field import gl64

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    n %= 64
    if n == 0:
        return x
    with np.errstate(over="ignore"):
        return (x << np.uint64(n)) | (x >> np.uint64(64 - n))


def keccak_f(state: np.ndarray) -> np.ndarray:
    """keccak-f[1600] on a (..., 5, 5) u64 lane array (batched)."""
    a = state.copy()
    with np.errstate(over="ignore"):
        for rc in _RC:
            # theta
            c = a[..., 0, :] ^ a[..., 1, :] ^ a[..., 2, :] ^ a[..., 3, :] ^ a[..., 4, :]
            d = np.empty_like(c)
            for x in range(5):
                d[..., x] = c[..., (x - 1) % 5] ^ _rotl(c[..., (x + 1) % 5], 1)
            a = a ^ d[..., None, :]
            # rho + pi
            b = np.empty_like(a)
            for x in range(5):
                for y in range(5):
                    b[..., (2 * x + 3 * y) % 5, y] = _rotl(a[..., y, x], _ROT[x][y])
            # chi
            for y in range(5):
                row = b[..., y, :].copy()
                for x in range(5):
                    a[..., y, x] = row[..., x] ^ (~row[..., (x + 1) % 5]
                                                  & row[..., (x + 2) % 5])
            # iota
            a[..., 0, 0] ^= np.uint64(rc)
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (pre-NIST padding 0x01, as used by Ethereum)."""
    rate = 136
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80

    state = np.zeros((5, 5), dtype=np.uint64)
    for off in range(0, len(padded), rate):
        block = np.frombuffer(padded[off:off + rate], dtype="<u8")
        for i, lane in enumerate(block):
            state[i // 5, i % 5] ^= lane
        state = keccak_f(state)
    return state.reshape(-1)[:4].astype("<u8").tobytes()[:32]


HASH_SIZE = 25  # bytes (reference KeccakHash<25>)


def _felts_to_bytes(felts) -> bytes:
    arr = gl64.to_canonical(np.asarray(felts, dtype=np.uint64)).astype("<u8")
    return arr.tobytes()


def hash_n_to_bytes(felts, size: int = HASH_SIZE) -> bytes:
    """KeccakHash::hash_no_pad (keccak.rs:104): keccak256 of the LE felt
    bytes, truncated to `size`."""
    return keccak256(_felts_to_bytes(felts))[:size]


def two_to_one(left: bytes, right: bytes, size: int = HASH_SIZE) -> bytes:
    """Merkle 2-to-1 compression over byte digests."""
    return keccak256(left + right)[:size]
