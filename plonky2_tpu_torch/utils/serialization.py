"""Binary serialization of STARK proofs.

Twin of the repo's self-describing single-table STARK layout (reference
conventions from plonky2/src/util/serialization/mod.rs: little-endian
fixed-width integers, field elements as canonical u64 LE, hashes as 4 field
elements, length-prefixed vectors).  Only what a STARK proof needs.
"""

from __future__ import annotations

import struct

import numpy as np

from ..field import gl64
from ..fri.proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep
from ..hash.merkle import MerkleCap, MerkleProof


class Buffer:
    """Byte writer/reader (reference serialization/mod.rs Buffer:2128)."""

    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)
        self.pos = 0

    def bytes(self) -> bytes:
        return bytes(self.data)

    # -- writes ---------------------------------------------------------
    def write_u8(self, v: int):
        self.data += struct.pack("<B", v)

    def write_usize(self, v: int):
        self.data += struct.pack("<Q", v)

    def write_bool(self, v: bool):
        self.write_u8(1 if v else 0)

    def write_field(self, v):
        self.data += struct.pack("<Q", int(v) % gl64.ORDER_INT)

    def write_field_vec(self, vs):
        for v in np.asarray(vs, dtype=np.uint64).reshape(-1):
            self.write_field(v)

    def write_ext_vec(self, vs):
        """Extension elements back to back, no length prefix."""
        self.write_field_vec(np.asarray(vs, dtype=np.uint64).reshape(-1, 2))

    def write_hash(self, h):
        self.write_field_vec(np.asarray(h, dtype=np.uint64).reshape(4))

    def write_hash_vec(self, hashes):
        """usize-length-prefixed hash list (mod.rs:1352)."""
        hashes = np.asarray(hashes, dtype=np.uint64).reshape(-1, 4)
        self.write_usize(len(hashes))
        for h in hashes:
            self.write_hash(h)

    def write_merkle_proof(self, proof: MerkleProof):
        """u8 sibling count + hashes (mod.rs:1443)."""
        self.write_u8(len(proof.siblings))
        for h in proof.siblings:
            self.write_hash(h)

    # -- reads ----------------------------------------------------------
    def _take(self, n: int) -> bytes:
        out = bytes(self.data[self.pos:self.pos + n])
        if len(out) != n:
            raise ValueError("buffer underrun")
        self.pos += n
        return out

    def read_u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def read_usize(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def read_bool(self) -> bool:
        return self.read_u8() != 0

    def read_field(self) -> np.uint64:
        return np.uint64(struct.unpack("<Q", self._take(8))[0])

    def read_field_vec(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(8 * n), dtype="<u8").astype(np.uint64)

    def read_ext_vec(self, n: int) -> np.ndarray:
        return self.read_field_vec(2 * n).reshape(n, 2)

    def read_hash_vec(self) -> np.ndarray:
        n = self.read_usize()
        return self.read_field_vec(4 * n).reshape(n, 4)

    def read_merkle_proof(self) -> MerkleProof:
        n = self.read_u8()
        return MerkleProof(self.read_field_vec(4 * n).reshape(n, 4))


def write_fri_proof_sd(buf: Buffer, fp: FriProof):
    """Self-describing (length-prefixed) FRI proof."""
    buf.write_usize(len(fp.commit_phase_merkle_caps))
    for cap in fp.commit_phase_merkle_caps:
        buf.write_hash_vec(cap.data)
    buf.write_usize(len(fp.query_round_proofs))
    for q in fp.query_round_proofs:
        buf.write_usize(len(q.initial_trees_proof.evals_proofs))
        for leaves, mp in q.initial_trees_proof.evals_proofs:
            buf.write_usize(len(leaves))
            buf.write_field_vec(leaves)
            buf.write_merkle_proof(mp)
        buf.write_usize(len(q.steps))
        for s in q.steps:
            evals = np.asarray(s.evals, dtype=np.uint64).reshape(-1, 2)
            buf.write_usize(len(evals))
            buf.write_ext_vec(evals)
            buf.write_merkle_proof(s.merkle_proof)
    final_poly = np.asarray(fp.final_poly, dtype=np.uint64).reshape(-1, 2)
    buf.write_usize(len(final_poly))
    buf.write_ext_vec(final_poly)
    buf.write_field(fp.pow_witness)


def read_fri_proof_sd(buf: Buffer) -> FriProof:
    caps = [MerkleCap(buf.read_hash_vec()) for _ in range(buf.read_usize())]
    rounds = []
    for _ in range(buf.read_usize()):
        evals_proofs = []
        for _ in range(buf.read_usize()):
            n = buf.read_usize()
            leaves = buf.read_field_vec(n)
            evals_proofs.append((leaves, buf.read_merkle_proof()))
        steps = [FriQueryStep(buf.read_ext_vec(buf.read_usize()),
                              buf.read_merkle_proof())
                 for _ in range(buf.read_usize())]
        rounds.append(FriQueryRound(FriInitialTreeProof(evals_proofs), steps))
    final_poly = buf.read_ext_vec(buf.read_usize())
    pow_witness = buf.read_field()
    return FriProof(caps, rounds, final_poly, pow_witness)


def stark_proof_to_bytes(spwp) -> bytes:
    """Byte encoding of a single-table StarkProofWithPublicInputs."""
    buf = Buffer()
    p = spwp.proof
    buf.write_hash_vec(p.trace_cap.data)
    buf.write_bool(p.permutation_zs_cap is not None)
    if p.permutation_zs_cap is not None:
        buf.write_hash_vec(p.permutation_zs_cap.data)
    buf.write_hash_vec(p.quotient_polys_cap.data)
    os_ = p.openings
    for arr in (os_.local_values, os_.next_values, os_.permutation_zs,
                os_.permutation_zs_next, os_.quotient_polys):
        arr = np.asarray(arr, np.uint64).reshape(-1, 2)
        buf.write_usize(len(arr))
        buf.write_ext_vec(arr)
    write_fri_proof_sd(buf, p.opening_proof)
    pis = np.asarray(spwp.public_inputs, np.uint64).reshape(-1)
    buf.write_usize(len(pis))
    buf.write_field_vec(pis)
    return buf.bytes()


def stark_proof_from_bytes(data: bytes):
    from ..stark.proof import (StarkOpeningSet, StarkProof,
                               StarkProofWithPublicInputs)
    buf = Buffer(data)
    trace_cap = MerkleCap(buf.read_hash_vec())
    perm_cap = MerkleCap(buf.read_hash_vec()) if buf.read_bool() else None
    quot_cap = MerkleCap(buf.read_hash_vec())
    vecs = [buf.read_ext_vec(buf.read_usize()) for _ in range(5)]
    opening_proof = read_fri_proof_sd(buf)
    pis = buf.read_field_vec(buf.read_usize())
    openings = StarkOpeningSet(local_values=vecs[0], next_values=vecs[1],
                               permutation_zs=vecs[2],
                               permutation_zs_next=vecs[3],
                               quotient_polys=vecs[4])
    return StarkProofWithPublicInputs(
        StarkProof(trace_cap, quot_cap, openings, opening_proof,
                   permutation_zs_cap=perm_cap), pis)
