"""Binary serialization of PLONK and STARK proofs.

Twin of reference plonky2/src/util/serialization/mod.rs: little-endian
fixed-width integers, field elements as canonical u64 LE, hashes as 4 field
elements (Poseidon) or their raw bytes (keccak configs, KeccakHash<25>).
PLONK proofs use the reference's wire format (no length prefixes but the
public-input count: every count follows from CommonCircuitData); STARK
proofs (single- and multi-table) the repo's own self-describing,
length-prefixed layout.  Circuit-data checkpoints are not ported yet
(ROADMAP Queue 1 item 8): ``circuit_data_to_bytes`` and
``circuit_data_from_bytes`` raise.
"""

from __future__ import annotations

import struct

import numpy as np

from ..field import gl64
from ..fri.proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep
from ..hash.keccak import HASH_SIZE
from ..hash.keccak_tree import BytesMerkleCap
from ..hash.merkle import MerkleCap, MerkleProof
from ..plonk.proof import OpeningSet, Proof, ProofWithPublicInputs


class Buffer:
    """Byte writer/reader (reference serialization/mod.rs Buffer:2128)."""

    def __init__(self, data: bytes = b"", digest_bytes: int | None = None):
        self.data = bytearray(data)
        self.pos = 0
        # digest kind for reads: None = 4-felt Poseidon hashes; an int =
        # raw byte digests of that size (keccak config, KeccakHash<25>).
        # Writers dispatch on the array dtype instead (uint8 = bytes).
        self.digest_bytes = digest_bytes

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

    def write_ext(self, v):
        self.write_field_vec(np.asarray(v, dtype=np.uint64).reshape(2))

    def write_ext_vec(self, vs):
        """Extension elements back to back, no length prefix."""
        self.write_field_vec(np.asarray(vs, dtype=np.uint64).reshape(-1, 2))

    def write_hash(self, h):
        h = np.asarray(h)
        if h.dtype == np.uint8:   # byte digest (keccak.rs BytesHash)
            self.data += h.reshape(-1).tobytes()
            return
        self.write_field_vec(h.astype(np.uint64).reshape(4))

    def write_cap(self, cap: MerkleCap):
        """Cap hashes back to back, no length prefix (mod.rs:1367): the
        reader knows cap_height from the config."""
        for h in cap.data:
            self.write_hash(h)

    def write_hash_vec(self, hashes):
        """usize-length-prefixed hash list (mod.rs:1352)."""
        hashes = np.asarray(hashes)
        if hashes.dtype != np.uint8:
            hashes = hashes.astype(np.uint64).reshape(-1, 4)
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

    def read_ext(self) -> np.ndarray:
        return self.read_field_vec(2)

    def read_ext_vec(self, n: int) -> np.ndarray:
        return self.read_field_vec(2 * n).reshape(n, 2)

    def _read_hashes(self, n: int) -> np.ndarray:
        """n digests: (n, 4) u64 felts, or (n, digest_bytes) uint8."""
        db = self.digest_bytes
        if db:
            return np.frombuffer(self._take(n * db), np.uint8).reshape(n, db)
        return self.read_field_vec(4 * n).reshape(n, 4)

    def make_cap(self, data: np.ndarray):
        return BytesMerkleCap(data) if self.digest_bytes else MerkleCap(data)

    def read_cap(self, cap_height: int):
        return self.make_cap(self._read_hashes(1 << cap_height))

    def read_hash_vec(self) -> np.ndarray:
        return self._read_hashes(self.read_usize())

    def read_merkle_proof(self) -> MerkleProof:
        return MerkleProof(self._read_hashes(self.read_u8()))


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
    caps = [buf.make_cap(buf.read_hash_vec()) for _ in range(buf.read_usize())]
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


# -- PLONK proofs (byte-exact reference wire format) -------------------------

SALT_SIZE = 4  # reference plonk_common.rs salt_size(hiding): 4 felts


def write_opening_set(buf: Buffer, os_: OpeningSet):
    """Field order per reference mod.rs:1409 (lookups between zs_next and
    partial_products)."""
    for arr in (os_.constants, os_.plonk_sigmas, os_.wires, os_.plonk_zs,
                os_.plonk_zs_next, os_.lookup_zs, os_.lookup_zs_next,
                os_.partial_products, os_.quotient_polys):
        buf.write_ext_vec(arr)


def read_opening_set(buf: Buffer, common) -> OpeningSet:
    """reference mod.rs:334"""
    cfg = common.config
    constants = buf.read_ext_vec(common.num_constants)
    plonk_sigmas = buf.read_ext_vec(cfg.num_routed_wires)
    wires = buf.read_ext_vec(cfg.num_wires)
    plonk_zs = buf.read_ext_vec(cfg.num_challenges)
    plonk_zs_next = buf.read_ext_vec(cfg.num_challenges)
    lookup_zs = buf.read_ext_vec(common.num_all_lookup_polys())
    lookup_zs_next = buf.read_ext_vec(common.num_all_lookup_polys())
    partial_products = buf.read_ext_vec(common.num_partial_products
                                        * cfg.num_challenges)
    quotient_polys = buf.read_ext_vec(common.quotient_degree_factor
                                      * cfg.num_challenges)
    return OpeningSet(constants, plonk_sigmas, wires, plonk_zs, plonk_zs_next,
                      partial_products, quotient_polys, lookup_zs,
                      lookup_zs_next)


def write_fri_proof(buf: Buffer, fp: FriProof):
    """reference mod.rs:1568: caps, query rounds, final poly, pow witness,
    all without counts (they follow from FriParams)."""
    for cap in fp.commit_phase_merkle_caps:
        buf.write_cap(cap)
    for q in fp.query_round_proofs:
        for leaves, mp in q.initial_trees_proof.evals_proofs:
            buf.write_field_vec(leaves)
            buf.write_merkle_proof(mp)
        for s in q.steps:
            buf.write_ext_vec(s.evals)
            buf.write_merkle_proof(s.merkle_proof)
    buf.write_ext_vec(fp.final_poly)
    buf.write_field(fp.pow_witness)


def read_fri_proof(buf: Buffer, common) -> FriProof:
    """reference mod.rs:555 (+read_fri_initial_proof:422,
    read_fri_query_rounds:506)."""
    cfg = common.config
    params = common.fri_params
    cap_height = cfg.fri_config.cap_height
    caps = [buf.read_cap(cap_height) for _ in params.reduction_arity_bits]
    salt = SALT_SIZE if params.hiding else 0
    oracle_widths = [
        common.num_constants + cfg.num_routed_wires,
        cfg.num_wires + salt,
        cfg.num_challenges * (1 + common.num_partial_products
                              + common.num_lookup_polys) + salt,
        cfg.num_challenges * common.quotient_degree_factor + salt,
    ]
    rounds = []
    for _ in range(cfg.fri_config.num_query_rounds):
        evals_proofs = []
        for width in oracle_widths:
            leaves = buf.read_field_vec(width)
            evals_proofs.append((leaves, buf.read_merkle_proof()))
        steps = [FriQueryStep(buf.read_ext_vec(1 << ar),
                              buf.read_merkle_proof())
                 for ar in params.reduction_arity_bits]
        rounds.append(FriQueryRound(FriInitialTreeProof(evals_proofs), steps))
    final_poly = buf.read_ext_vec(params.final_poly_len())
    pow_witness = buf.read_field()
    return FriProof(caps, rounds, final_poly, pow_witness)


def write_proof(buf: Buffer, proof: Proof):
    buf.write_cap(proof.wires_cap)
    buf.write_cap(proof.plonk_zs_partial_products_cap)
    buf.write_cap(proof.quotient_polys_cap)
    write_opening_set(buf, proof.openings)
    write_fri_proof(buf, proof.opening_proof)


def read_proof(buf: Buffer, common) -> Proof:
    cap_height = common.config.fri_config.cap_height
    return Proof(buf.read_cap(cap_height), buf.read_cap(cap_height),
                 buf.read_cap(cap_height), read_opening_set(buf, common),
                 read_fri_proof(buf, common))


def proof_with_pis_to_bytes(pwp: ProofWithPublicInputs) -> bytes:
    """reference mod.rs:1963 write_proof_with_public_inputs (the one spot
    that is length-prefixed: the public-input count)."""
    buf = Buffer()
    write_proof(buf, pwp.proof)
    buf.write_usize(len(pwp.public_inputs))
    buf.write_field_vec(pwp.public_inputs)
    return buf.bytes()


def digest_bytes_for(hasher: str) -> int | None:
    """Byte-digest size for a hasher config, None for felt digests."""
    return HASH_SIZE if hasher == "keccak" else None


def proof_with_pis_from_bytes(data: bytes, common) -> ProofWithPublicInputs:
    buf = Buffer(data, digest_bytes_for(common.config.hasher))
    proof = read_proof(buf, common)
    n = buf.read_usize()
    return ProofWithPublicInputs(proof, buf.read_field_vec(n))


# -- circuit-data checkpoints --------------------------------------------------

def circuit_data_to_bytes(data) -> bytes:
    """Not ported yet: circuit-data checkpoints are ROADMAP Queue 1 item 8,
    which follows the recursion slice (item 10)."""
    raise NotImplementedError(
        "circuit-data checkpoints are not ported yet (ROADMAP Queue 1 item 8)")


def circuit_data_from_bytes(data: bytes, device=None):
    """Not ported yet (ROADMAP Queue 1 item 8); see circuit_data_to_bytes."""
    raise NotImplementedError(
        "circuit-data checkpoints are not ported yet (ROADMAP Queue 1 item 8)")
