"""Binary serialization of multi-table STARK proofs (checkpoint/resume
parity with the reference's Read/Write layer for AllProof,
util/serialization/mod.rs + evm/src/proof.rs)."""

from __future__ import annotations

import numpy as np

from ..stark.multi import (MultiProof, MultiStarkOpeningSet,
                           MultiTableStarkProof)
from ..utils.serialization import (Buffer, digest_bytes_for,
                                   read_fri_proof_sd, write_fri_proof_sd)


def _write_ext_matrix(buf: Buffer, m: np.ndarray) -> None:
    buf.write_usize(m.shape[0])
    for row in np.asarray(m, np.uint64):
        buf.write_ext(row)


def _read_ext_matrix(buf: Buffer) -> np.ndarray:
    n = buf.read_usize()
    return np.stack([buf.read_ext() for _ in range(n)]) if n else \
        np.zeros((0, 2), np.uint64)


def write_multi_stark_proof(buf: Buffer, p: MultiTableStarkProof) -> None:
    buf.write_usize(p.degree_bits)
    buf.write_hash_vec(p.trace_cap.data)
    buf.write_hash_vec(p.permutation_ctl_zs_cap.data)
    buf.write_hash_vec(p.quotient_polys_cap.data)
    o = p.openings
    _write_ext_matrix(buf, o.local_values)
    _write_ext_matrix(buf, o.next_values)
    _write_ext_matrix(buf, o.permutation_ctl_zs)
    _write_ext_matrix(buf, o.permutation_ctl_zs_next)
    buf.write_usize(len(o.ctl_zs_last))
    buf.write_field_vec(np.asarray(o.ctl_zs_last, np.uint64))
    _write_ext_matrix(buf, o.quotient_polys)
    write_fri_proof_sd(buf, p.opening_proof)
    # challenger boundary state (StarkProofWithMetadata): staged per-table
    # recursion asserts its presence, so round-tripped proofs must carry
    # it.  Presence flag + the 12-felt sponge state.
    if p.init_challenger_state is None:
        buf.write_u8(0)
    else:
        buf.write_u8(1)
        buf.write_field_vec(np.asarray(p.init_challenger_state, np.uint64))


def read_multi_stark_proof(buf: Buffer) -> MultiTableStarkProof:
    degree_bits = buf.read_usize()
    trace_cap = buf.make_cap(buf.read_hash_vec())
    zs_cap = buf.make_cap(buf.read_hash_vec())
    quot_cap = buf.make_cap(buf.read_hash_vec())
    local_values = _read_ext_matrix(buf)
    next_values = _read_ext_matrix(buf)
    zs = _read_ext_matrix(buf)
    zs_next = _read_ext_matrix(buf)
    n_ctl = buf.read_usize()
    ctl_zs_last = buf.read_field_vec(n_ctl)
    quotient_polys = _read_ext_matrix(buf)
    opening_proof = read_fri_proof_sd(buf)
    init_state = buf.read_field_vec(12) if buf.read_u8() else None
    return MultiTableStarkProof(
        trace_cap=trace_cap,
        permutation_ctl_zs_cap=zs_cap,
        quotient_polys_cap=quot_cap,
        openings=MultiStarkOpeningSet(
            local_values=local_values, next_values=next_values,
            permutation_ctl_zs=zs, permutation_ctl_zs_next=zs_next,
            ctl_zs_last=ctl_zs_last, quotient_polys=quotient_polys),
        opening_proof=opening_proof,
        degree_bits=degree_bits,
        init_challenger_state=init_state)


def multi_proof_to_bytes(proof: MultiProof, hasher: str = "poseidon") -> bytes:
    """The digests' dtype decides how they are written; ``hasher`` is kept
    for the reference's signature."""
    buf = Buffer()
    buf.write_usize(len(proof.stark_proofs))
    for p in proof.stark_proofs:
        write_multi_stark_proof(buf, p)
    return buf.bytes()


def multi_proof_from_bytes(data: bytes,
                           hasher: str = "poseidon") -> MultiProof:
    buf = Buffer(data, digest_bytes_for(hasher))
    n = buf.read_usize()
    return MultiProof([read_multi_stark_proof(buf) for _ in range(n)])
