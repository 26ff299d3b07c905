"""Binary serialization of PLONK and STARK proofs.

Twin of reference plonky2/src/util/serialization/mod.rs: little-endian
fixed-width integers, field elements as canonical u64 LE, hashes as 4 field
elements (Poseidon) or their raw bytes (keccak configs, KeccakHash<25>).
PLONK proofs use the reference's wire format (no length prefixes but the
public-input count: every count follows from CommonCircuitData); STARK
proofs (single- and multi-table) the repo's own self-describing,
length-prefixed layout.  Circuit-data checkpoints (common, verifier and
prover data: the leveled witness schedule, the sigmas, the constants and
sigmas commitment with its whole Merkle tree) use the JAX package's format
byte for byte, so a checkpoint written by either package reads in the
other.  Port change: the writer pulls the commitment's coefficients and
tree levels from the device, and the reader uploads them onto the
``device`` it is given (CUDA unless the caller names another) and rebuilds
the natural-order LDE values from the tree's leaves, without a re-commit.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import math
import re
import struct

import numpy as np

from ..field import gl64
from ..field.goldilocks import GF
from ..fri.config import FriConfig, FriParams, FriReductionStrategy
from ..fri.proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep
from ..hash.keccak import HASH_SIZE
from ..hash.keccak_tree import BytesMerkleCap, BytesMerkleTree
from ..hash.merkle import MerkleCap, MerkleProof, MerkleTree
from ..plonk import targets as tg
from ..plonk.circuit_data import (CircuitData, CommonCircuitData,
                                  ProverOnlyCircuitData, SelectorsInfo,
                                  VerifierOnlyCircuitData)
from ..plonk.config import CircuitConfig
from ..plonk.gates.base import GeneratorSpec
from ..plonk.generators import build_custom_fn
from ..plonk.proof import OpeningSet, Proof, ProofWithPublicInputs
from ..plonk.witness import WitnessSchedule, _Group
from .bits import reverse_index_bits_perm
from .cuda import resolve_device


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

    def write_u32(self, v: int):
        self.data += struct.pack("<I", v)

    def write_usize(self, v: int):
        self.data += struct.pack("<Q", v)

    def write_str(self, s: str):
        b = s.encode("utf-8")
        self.write_usize(len(b))
        self.data += b

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

    def read_u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def read_usize(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def read_str(self) -> str:
        return self._take(self.read_usize()).decode("utf-8")

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

    def read_hash(self) -> np.ndarray:
        return self._read_hashes(1)[0]

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


# -- circuit data (common, verifier, prover) ------------------------------------

def gate_from_id(gate_id: str):
    """Rebuild a gate from its id() string (the registry twin of
    impl_gate_serializer!, gate_serialization.rs:48)."""
    from ..plonk.gates.arithmetic import ArithmeticGate
    from ..plonk.gates.ext_gates import (ArithmeticExtensionGate,
                                         MulExtensionGate, PoseidonMdsGate,
                                         ReducingExtensionGate, ReducingGate)
    from ..plonk.gates.interpolation import CosetInterpolationGate
    from ..plonk.gates.lookup import LookupGate, LookupTableGate
    from ..plonk.gates.misc import (BaseSumGate, ExponentiationGate,
                                    RandomAccessGate)
    from ..plonk.gates.poseidon_gate import PoseidonGate
    from ..plonk.gates.simple import ConstantGate, NoopGate, PublicInputGate

    ints = [int(x) for x in re.findall(r"-?\d+", gate_id)]
    simple = {"PoseidonMdsGate": PoseidonMdsGate, "PoseidonGate": PoseidonGate,
              "NoopGate": NoopGate, "PublicInputGate": PublicInputGate}
    one_int = {"ArithmeticGate": ArithmeticGate,
               "ArithmeticExtensionGate": ArithmeticExtensionGate,
               "MulExtensionGate": MulExtensionGate,
               "ReducingExtensionGate": ReducingExtensionGate,
               "ReducingGate": ReducingGate, "ConstantGate": ConstantGate,
               "ExponentiationGate": ExponentiationGate}
    name = re.match(r"[A-Za-z]+", gate_id).group(0)
    if name in simple:
        return simple[name]()
    if name in one_int:
        return one_int[name](ints[0])
    if name == "BaseSumGate":
        return BaseSumGate(ints[0], ints[1])
    if name == "RandomAccessGate":
        return RandomAccessGate(ints[0], ints[1], ints[2])
    if name == "CosetInterpolationGate":
        gate = CosetInterpolationGate(ints[0], 1 << ints[0])
        gate._degree = ints[1]
        return gate
    if name == "LookupTableGate":
        return LookupTableGate(ints[0], ints[1], ints[2])
    if name == "LookupGate":
        return LookupGate(ints[0], ints[1])
    raise ValueError(f"unknown gate id: {gate_id}")


def write_fri_params(buf: Buffer, params: FriParams):
    cfg = params.config
    buf.write_u32(cfg.rate_bits)
    buf.write_u32(cfg.cap_height)
    buf.write_u32(cfg.proof_of_work_bits)
    buf.write_str(cfg.reduction_strategy.kind)
    buf.write_usize(len(cfg.reduction_strategy.arity_bits))
    for a in cfg.reduction_strategy.arity_bits:
        buf.write_u32(a)
    buf.write_u32(cfg.reduction_strategy.final_poly_bits)
    buf.write_u32(cfg.reduction_strategy.num_queries_hint)
    buf.write_u32(cfg.num_query_rounds)
    buf.write_bool(params.hiding)
    buf.write_u32(params.degree_bits)
    buf.write_usize(len(params.reduction_arity_bits))
    for a in params.reduction_arity_bits:
        buf.write_u32(a)


def read_fri_params(buf: Buffer) -> FriParams:
    rate_bits = buf.read_u32()
    cap_height = buf.read_u32()
    pow_bits = buf.read_u32()
    kind = buf.read_str()
    arity_bits = tuple(buf.read_u32() for _ in range(buf.read_usize()))
    final_poly_bits = buf.read_u32()
    num_queries_hint = buf.read_u32()
    num_query_rounds = buf.read_u32()
    config = FriConfig(rate_bits, cap_height, pow_bits,
                       FriReductionStrategy(kind, arity_bits, final_poly_bits,
                                            num_queries_hint),
                       num_query_rounds)
    hiding = buf.read_bool()
    degree_bits = buf.read_u32()
    red = tuple(buf.read_u32() for _ in range(buf.read_usize()))
    return FriParams(config, hiding, degree_bits, red)


def common_data_to_bytes(common: CommonCircuitData) -> bytes:
    buf = Buffer()
    c = common.config
    for v in (c.num_wires, c.num_routed_wires, c.num_constants,
              c.security_bits, c.num_challenges, c.max_quotient_degree_factor):
        buf.write_u32(v)
    buf.write_bool(c.zero_knowledge)
    buf.write_str(c.hasher)
    write_fri_params(buf, common.fri_params)
    buf.write_usize(len(common.gates))
    for g in common.gates:
        buf.write_str(g.id())
    si = common.selectors_info
    buf.write_usize(len(si.selector_indices))
    for i in si.selector_indices:
        buf.write_u32(i)
    buf.write_usize(len(si.groups))
    for r in si.groups:
        buf.write_u32(r.start)
        buf.write_u32(r.stop)
    buf.write_u32(common.quotient_degree_factor)
    buf.write_u32(common.num_gate_constraints)
    buf.write_u32(common.num_constants)
    buf.write_u32(common.num_public_inputs)
    buf.write_usize(len(common.k_is))
    buf.write_field_vec(common.k_is)
    buf.write_u32(common.num_partial_products)
    buf.write_u32(common.num_lookup_polys)
    buf.write_u32(common.num_lookup_selectors)
    buf.write_usize(len(common.luts))
    for lut in common.luts:
        buf.write_usize(len(lut))
        for a, b in lut:
            buf.write_u32(a)
            buf.write_u32(b)
    return buf.bytes()


def common_data_from_bytes(data: bytes) -> CommonCircuitData:
    buf = Buffer(data)
    (num_wires, num_routed_wires, num_constants_cfg, security_bits,
     num_challenges, max_qdf) = (buf.read_u32() for _ in range(6))
    zero_knowledge = buf.read_bool()
    hasher = buf.read_str()
    fri_params = read_fri_params(buf)
    config = CircuitConfig(
        num_wires=num_wires, num_routed_wires=num_routed_wires,
        num_constants=num_constants_cfg, security_bits=security_bits,
        num_challenges=num_challenges, zero_knowledge=zero_knowledge,
        max_quotient_degree_factor=max_qdf, fri_config=fri_params.config,
        hasher=hasher)
    gates = [gate_from_id(buf.read_str()) for _ in range(buf.read_usize())]
    selector_indices = [buf.read_u32() for _ in range(buf.read_usize())]
    groups = [range(buf.read_u32(), buf.read_u32())
              for _ in range(buf.read_usize())]
    quotient_degree_factor = buf.read_u32()
    num_gate_constraints = buf.read_u32()
    num_constants = buf.read_u32()
    num_public_inputs = buf.read_u32()
    k_is = buf.read_field_vec(buf.read_usize())
    num_partial_products = buf.read_u32()
    num_lookup_polys = buf.read_u32()
    num_lookup_selectors = buf.read_u32()
    luts = []
    for _ in range(buf.read_usize()):
        n = buf.read_usize()
        luts.append(tuple((buf.read_u32(), buf.read_u32()) for _ in range(n)))
    return CommonCircuitData(
        config=config, fri_params=fri_params, gates=gates,
        selectors_info=SelectorsInfo(selector_indices, groups),
        quotient_degree_factor=quotient_degree_factor,
        num_gate_constraints=num_gate_constraints,
        num_constants=num_constants, num_public_inputs=num_public_inputs,
        k_is=k_is, num_partial_products=num_partial_products,
        num_lookup_polys=num_lookup_polys,
        num_lookup_selectors=num_lookup_selectors, luts=luts)


def verifier_data_to_bytes(vd: VerifierOnlyCircuitData) -> bytes:
    """reference mod.rs:1889: usize cap height, cap hashes, digest."""
    buf = Buffer()
    buf.write_usize(int(math.log2(vd.constants_sigmas_cap.data.shape[0])))
    buf.write_cap(vd.constants_sigmas_cap)
    buf.write_hash(vd.circuit_digest)
    return buf.bytes()


def verifier_data_from_bytes(data: bytes,
                             hasher: str = "poseidon") -> VerifierOnlyCircuitData:
    buf = Buffer(data, digest_bytes_for(hasher))
    height = buf.read_usize()
    return VerifierOnlyCircuitData(buf.read_cap(height), buf.read_hash())


# -- prover data (full CircuitData checkpoint) ---------------------------------
#
# Twin of the reference's write/read_circuit_data (mod.rs:790,1786): the
# expensive build() artifacts (the leveled witness schedule, whose custom
# generators are named in plonk/generators.py's registry, the sigmas, and the
# constants+sigmas PolynomialBatch with its full Merkle tree) round-trip, so
# proving resumes from a checkpoint without a rebuild.

def _write_array(buf: Buffer, arr, dtype: str) -> None:
    arr = np.asarray(arr)
    buf.write_usize(arr.ndim)
    for d in arr.shape:
        buf.write_usize(d)
    buf.data += arr.astype(dtype).tobytes()


def _read_array(buf: Buffer, dtype: str, out_dtype) -> np.ndarray:
    shape = tuple(buf.read_usize() for _ in range(buf.read_usize()))
    n = int(np.prod(shape)) if shape else 1
    return np.frombuffer(buf._take(8 * n), dtype=dtype).astype(
        out_dtype).reshape(shape)


def _write_i64s(buf: Buffer, arr) -> None:
    _write_array(buf, np.asarray(arr, np.int64), "<i8")


def _read_i64s(buf: Buffer) -> np.ndarray:
    return _read_array(buf, "<i8", np.int64)


def _write_u64s(buf: Buffer, arr) -> None:
    _write_array(buf, np.asarray(arr, np.uint64), "<u8")


def _read_u64s(buf: Buffer) -> np.ndarray:
    return _read_array(buf, "<u8", np.uint64)


# Target trees name their dataclasses by module path.  The format carries the
# JAX package's path (the same module tree under another top-level name), so
# a checkpoint reads in either package.
_FORMAT_PACKAGE = "plonky2_tpu"
_PACKAGE = __name__.split(".")[0]


def encode_target_tree(obj):
    """Proof-target structures (nested dataclasses whose leaves are plain
    int targets) -> a pure-literal tagged tree, so expensively built
    circuits can checkpoint their attached targets (the reference
    serializes every *Target struct explicitly, mod.rs:1504-1762; one
    generic codec covers them all)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        module = type(obj).__module__
        assert module.split(".")[0] == _PACKAGE, module
        return ("D", _FORMAT_PACKAGE + module[len(_PACKAGE):],
                type(obj).__name__,
                tuple((f.name, encode_target_tree(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, tuple):
        return ("T", tuple(encode_target_tree(x) for x in obj))
    if isinstance(obj, list):
        return ("L", tuple(encode_target_tree(x) for x in obj))
    if isinstance(obj, (bool, int, np.integer)):
        return ("I", int(obj))
    if obj is None:
        return ("N",)
    raise TypeError(f"not a target tree: {type(obj)}")


def decode_target_tree(t):
    tag = t[0]
    if tag == "D":
        if t[1].split(".")[0] != _FORMAT_PACKAGE:
            raise ValueError(f"not a target-tree module: {t[1]}")
        module = importlib.import_module(_PACKAGE + t[1][len(_FORMAT_PACKAGE):])
        cls = getattr(module, t[2])
        return cls(**{k: decode_target_tree(v) for k, v in t[3]})
    if tag == "T":
        return tuple(decode_target_tree(x) for x in t[1])
    if tag == "L":
        return [decode_target_tree(x) for x in t[1]]
    if tag == "I":
        return t[1]
    if tag == "N":
        return None
    raise ValueError(t)


def _write_literal(buf: Buffer, obj) -> None:
    """Plain-data params (ints / tuples / lists): repr + literal_eval."""
    buf.write_str(repr(obj))


def _read_literal(buf: Buffer):
    return ast.literal_eval(buf.read_str())


def _registry_name(name):
    if name is None:
        raise ValueError("cannot checkpoint a custom generator without a "
                         "registry name (plonk/generators.py)")
    return name


def write_schedule(buf: Buffer, sched) -> None:
    buf.write_usize(sched.num_rows)
    buf.write_usize(sched.num_wires)
    buf.write_usize(sched.num_virtual)
    buf.write_bool(sched.rng_seed is not None)
    if sched.rng_seed is not None:
        buf.write_usize(sched.rng_seed)
    _write_i64s(buf, sched.parents)
    buf.write_usize(len(sched.levels))
    for groups in sched.levels:
        buf.write_usize(len(groups))
        for g in groups:
            buf.write_str(g.kind)
            _write_i64s(buf, g.dep_reps)
            _write_i64s(buf, g.out_reps)
            if isinstance(g.params, np.ndarray):
                buf.write_u8(0)
                _write_u64s(buf, g.params)
            else:
                buf.write_u8(1)
                _write_literal(buf, g.params)
            if g.kind == "custom":
                for name in g.names:
                    buf.write_str(_registry_name(name))
    # residual (dependency-cycle) generators
    buf.write_usize(len(sched._residual_specs))
    for spec, dreps, oreps in sched._residual_specs:
        buf.write_str(spec.kind)
        name = _registry_name(spec.name) if spec.kind == "custom" else spec.name
        buf.write_str(name or "")
        _write_literal(buf, spec.params)
        _write_i64s(buf, np.asarray(dreps, np.int64))
        _write_i64s(buf, np.asarray(oreps, np.int64))
    _write_i64s(buf, np.asarray(sorted(sched._residual_out_reps), np.int64))


def read_schedule(buf: Buffer, luts: list) -> WitnessSchedule:
    sched = object.__new__(WitnessSchedule)
    sched.num_rows = buf.read_usize()
    sched.num_wires = buf.read_usize()
    sched.num_virtual = buf.read_usize()
    sched.total = sched.num_rows * sched.num_wires + sched.num_virtual
    sched.rng_seed = buf.read_usize() if buf.read_bool() else None
    sched.parents = _read_i64s(buf)

    def dense(t: int) -> int:
        if tg.is_wire(t):
            return tg.wire_row(t) * sched.num_wires + tg.wire_column(t)
        return sched.num_rows * sched.num_wires + tg.virtual_index(t)

    sched._dense = dense
    levels = []
    for _ in range(buf.read_usize()):
        groups = []
        for _ in range(buf.read_usize()):
            kind = buf.read_str()
            dep_reps = _read_i64s(buf)
            out_reps = _read_i64s(buf)
            params = (_read_u64s(buf) if buf.read_u8() == 0
                      else _read_literal(buf))
            fns = names = None
            if kind == "custom":
                names = [buf.read_str() for _ in range(len(out_reps))]
                fns = [build_custom_fn(nm, tuple(params[i]), luts)
                       for i, nm in enumerate(names)]
            groups.append(_Group(kind, dep_reps, out_reps, params, fns,
                                 names))
        levels.append(groups)
    sched.levels = levels
    residual = []
    for _ in range(buf.read_usize()):
        kind = buf.read_str()
        name = buf.read_str() or None
        params = tuple(_read_literal(buf))
        dreps = [int(x) for x in _read_i64s(buf)]
        oreps = [int(x) for x in _read_i64s(buf)]
        fn = build_custom_fn(name, params, luts) if kind == "custom" else None
        residual.append((GeneratorSpec(kind, [], [], params, fn, name),
                         dreps, oreps))
    sched._residual_specs = residual
    sched.residual = list(range(len(residual)))
    sched._residual_out_reps = {int(x) for x in _read_i64s(buf)}
    return sched


def write_merkle_tree(buf: Buffer, tree) -> None:
    """The leaves and every digest level; a Poseidon tree's come off the
    device, a keccak tree's (uint8 digests) are host arrays already."""
    is_bytes = isinstance(tree, BytesMerkleTree)
    buf.write_u8(1 if is_bytes else 0)
    buf.write_usize(tree.cap_height)
    buf.write_usize(tree.leaf_len)
    if is_bytes:
        _write_u64s(buf, tree.leaves_np)
        buf.write_usize(len(tree.levels))
        for lvl in tree.levels:
            lvl = np.asarray(lvl, np.uint8)
            buf.write_usize(lvl.shape[0])
            buf.write_usize(lvl.shape[1])
            buf.data += lvl.tobytes()
        return
    _write_u64s(buf, tree.leaves.to_u64())
    buf.write_usize(len(tree.levels))
    for lvl in tree.levels:
        _write_u64s(buf, lvl.to_u64())


def read_merkle_tree(buf: Buffer, device):
    """A tree as written by ``write_merkle_tree``.  A Poseidon tree's levels
    are uploaded onto ``device`` and its leaf rows become the (leaf_len, n)
    columns of MerkleTree.from_columns (leaf i is column reverse_bits(i))."""
    is_bytes = buf.read_u8() == 1
    cap_height = buf.read_usize()
    leaf_len = buf.read_usize()
    leaves = _read_u64s(buf)
    if is_bytes:
        tree = object.__new__(BytesMerkleTree)
        tree.cap_height = cap_height
        tree.leaf_len = leaf_len
        levels = []
        for _ in range(buf.read_usize()):
            n, w = buf.read_usize(), buf.read_usize()
            levels.append(np.frombuffer(buf._take(n * w),
                                        np.uint8).reshape(n, w).copy())
        tree.leaves_np = leaves
        tree.levels = levels
        tree.cap = BytesMerkleCap(levels[-1])
        return tree
    levels = [GF.from_u64(_read_u64s(buf), device)
              for _ in range(buf.read_usize())]
    rows = leaves.reshape(-1, leaf_len)
    columns = GF.from_u64(np.ascontiguousarray(
        rows[reverse_index_bits_perm(rows.shape[0])].T), device)
    return MerkleTree.from_levels(levels, cap_height, columns)


def write_polynomial_batch(buf: Buffer, batch) -> None:
    buf.write_usize(batch.degree_log)
    buf.write_usize(batch.rate_bits)
    buf.write_bool(batch.blinding)
    _write_u64s(buf, batch.polynomials.to_u64())
    write_merkle_tree(buf, batch.merkle_tree)


def read_polynomial_batch(buf: Buffer, device):
    """A committed batch on ``device``.  Its natural-order LDE values are
    the tree's leaf rows, un-bit-reversed and transposed, less any salt
    columns: no LDE or hash runs again.  A Poseidon batch's LDE values are
    a view of its tree's columns, as a fresh commitment's are."""
    from ..fri.oracle import PolynomialBatch
    degree_log = buf.read_usize()
    rate_bits = buf.read_usize()
    blinding = buf.read_bool()
    polys = GF.from_u64(_read_u64s(buf), device)
    tree = read_merkle_tree(buf, device)
    k = polys.shape[0]
    if isinstance(tree, BytesMerkleTree):
        leaves = GF.from_u64(tree.leaves_np, device)
        perm = reverse_index_bits_perm(leaves.shape[0])
        lde_values = GF(leaves.take(perm, axis=0).transpose(1, 0)
                        .v[:k].contiguous())
        hasher = "keccak"
    else:
        lde_values = tree.columns[:k]
        hasher = "poseidon"
    return PolynomialBatch(polys, lde_values, tree, degree_log, rate_bits,
                           blinding, hasher=hasher)


def prover_data_to_bytes(prover_only) -> bytes:
    buf = Buffer()
    write_schedule(buf, prover_only.schedule)
    write_polynomial_batch(buf, prover_only.constants_sigmas_commitment)
    _write_u64s(buf, prover_only.sigmas)
    _write_u64s(buf, prover_only.subgroup)
    _write_i64s(buf, prover_only.public_inputs)
    buf.write_hash(prover_only.circuit_digest)
    rows = prover_only.lookup_rows or []
    buf.write_usize(len(rows))
    for a, b, c in rows:
        buf.write_usize(a)
        buf.write_usize(b)
        buf.write_usize(c)
    return buf.bytes()


def prover_data_from_bytes(data: bytes, common: CommonCircuitData,
                           device=None) -> ProverOnlyCircuitData:
    device = resolve_device(device)
    buf = Buffer(data, digest_bytes_for(common.config.hasher))
    schedule = read_schedule(buf, list(common.luts))
    commitment = read_polynomial_batch(buf, device)
    sigmas = _read_u64s(buf)
    subgroup = _read_u64s(buf)
    public_inputs = [int(t) for t in _read_i64s(buf)]
    circuit_digest = buf.read_hash()
    lookup_rows = [(buf.read_usize(), buf.read_usize(), buf.read_usize())
                   for _ in range(buf.read_usize())]
    return ProverOnlyCircuitData(
        schedule=schedule, constants_sigmas_commitment=commitment,
        sigmas=sigmas, subgroup=subgroup, public_inputs=public_inputs,
        circuit_digest=circuit_digest, lookup_rows=lookup_rows)


def circuit_data_to_bytes(data) -> bytes:
    """Full CircuitData (common + verifier + prover) checkpoint."""
    buf = Buffer()
    for blob in (common_data_to_bytes(data.common),
                 verifier_data_to_bytes(data.verifier_only),
                 prover_data_to_bytes(data.prover_only)):
        buf.write_usize(len(blob))
        buf.data += blob
    return buf.bytes()


def circuit_data_from_bytes(data: bytes, device=None) -> CircuitData:
    """A checkpoint read back with its prover data on ``device`` (None
    means CUDA): proofs of the result run there."""
    device = resolve_device(device)
    buf = Buffer(data)
    common = common_data_from_bytes(buf._take(buf.read_usize()))
    verifier_only = verifier_data_from_bytes(buf._take(buf.read_usize()),
                                             hasher=common.config.hasher)
    prover_only = prover_data_from_bytes(buf._take(buf.read_usize()), common,
                                         device)
    return CircuitData(prover_only, verifier_only, common)
