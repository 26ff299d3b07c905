"""Device groups: per-table placement on sub-meshes, and pipelined proof
streams.

Two SURVEY §2.5 strategies the flat mesh does not cover:

* **Per-table device groups** (the expert-parallel analogue): the zkEVM's
  tables are independent through their trace-commitment phase (the shared
  challenger consumes only the caps, reference evm/src/prover.rs:94), so
  each table's IFFT -> LDE -> Merkle runs on its own group of ranks.  Each
  rank computes only its group's tables, so the groups work concurrently;
  the finished commitments are then handed to every rank.

* **Pipeline parallelism** over a stream of independent proofs
  (aggregation leaves, per-transaction proofs): group 0 commits the trace
  of proof i+1 while group 1 proves proof i (quotient, openings and FRI).
  The intra-proof transcript is strictly sequential (each phase's
  challenge depends on the previous cap), so the profitable overlap is
  across proofs: the two-stage pipeline with the commitment as its first
  stage.

A group is a ``Mesh`` over a contiguous block of the world's ranks, with
its own process group (``mesh.split_mesh``); every rank holds every
group's Mesh, with rank -1 in those it is not a member of.  Both paths are
bit-identical to the single-device prover.
"""

from __future__ import annotations

import pickle

import torch

from ..field.goldilocks import GF
from ..fri.oracle import COSET_SHIFT, PolynomialBatch
from ..hash.merkle import MerkleTree
from ..utils.bits import log2_strict, reverse_index_bits_perm
from .fri import ShardedMerkleTree
from .mesh import (Mesh, all_gather, broadcast, broadcast_bytes, make_mesh,
                   recv, send, shard_polys, split_mesh)
from .prover import _lde_rows


def device_groups(num_groups: int, mesh: Mesh | None = None) -> list:
    """Split the mesh's ranks (by default the world's) into num_groups
    equal sub-meshes; every rank of the mesh must call this."""
    return split_mesh(mesh if mesh is not None else make_mesh(), num_groups)


class PendingBatch:
    """One group's sharded commitment of a (k, n) batch, not yet handed
    to the other ranks.

    On the group's ranks it holds each rank's block of the coefficients,
    leaves and local digest levels; elsewhere only the shapes.
    ``finalize()`` assembles, on every rank of the world, a
    PolynomialBatch interchangeable with ``PolynomialBatch.from_values``
    (same coefficients, LDE values, leaves, Merkle levels and cap).
    """

    def __init__(self, group: Mesh, k: int, n: int, rate_bits: int,
                 cap_height: int, coeffs: GF | None = None,
                 tree: ShardedMerkleTree | None = None):
        self.group = group
        self.k, self.n = k, n
        self.rate_bits = rate_bits
        self.cap_height = cap_height
        self._coeffs = coeffs
        self._tree = tree

    def _sizes(self) -> list:
        """Element counts of the flat hand-off: coefficients, leaves, then
        every Merkle level from the leaf digests up to the cap."""
        big = self.n << self.rate_bits
        bits = log2_strict(big)
        return ([self.k * self.n, big * self.k]
                + [(big >> lvl) * 4 for lvl in range(bits - self.cap_height + 1)])

    def flat(self) -> torch.Tensor:
        """The whole batch as one int64 vector (group members only): every
        rank's blocks gathered within the group, pad rows dropped."""
        g = self.group
        tree = self._tree
        coeffs = all_gather(self._coeffs.v, g)[:self.k]
        parts = [coeffs, all_gather(tree.leaves.v, g)]
        parts += [all_gather(lvl.v, g) for lvl in tree.levels]
        parts += [GF.from_u64(t, g.device).v for t in tree.top]
        return torch.cat([p.reshape(-1) for p in parts])

    def batch_from_flat(self, flat: torch.Tensor) -> PolynomialBatch:
        """The PolynomialBatch of a flat hand-off vector, on its device."""
        pieces = list(torch.split(flat, self._sizes()))
        big = self.n << self.rate_bits
        coeffs = GF(pieces[0].reshape(self.k, self.n))
        leaves = GF(pieces[1].reshape(big, self.k))
        levels = [GF(p.reshape(-1, 4)) for p in pieces[2:]]
        # leaf row i is LDE point rev(i); the permutation is an involution
        lde = GF(leaves.v[torch.as_tensor(reverse_index_bits_perm(big),
                                          device=flat.device)]
                 .transpose(0, 1).contiguous())
        tree = MerkleTree.from_levels(levels, self.cap_height, lde)
        return PolynomialBatch(coeffs, lde, tree, log2_strict(self.n),
                               self.rate_bits, False)

    def finalize(self) -> PolynomialBatch:
        """The batch on every rank of the world (a collective of the whole
        world): gathered within the group, broadcast from its first rank."""
        world = self.group.parent
        root = world.ranks.index(self.group.ranks[0])
        if self.group.is_member:
            flat = self.flat()
        else:
            flat = torch.zeros(sum(self._sizes()), dtype=torch.int64,
                               device=world.device)
        return self.batch_from_flat(broadcast(flat, world, src=root))


def sharded_polynomial_batch(values: GF, rate_bits: int, cap_height: int,
                             group: Mesh) -> PendingBatch:
    """PolynomialBatch.from_values distributed over one group: the group's
    ranks commit (the program of ``prover.sharded_commitment``, keeping the
    IFFT coefficients and every local digest level); the others only
    record the shapes.  values: the whole (k, n) batch (every rank passes
    the same)."""
    k, n = values.shape
    if not group.is_member:
        return PendingBatch(group, k, n, rate_bits, cap_height)
    blk = shard_polys(values, group)
    coeffs, _, rows = _lde_rows(blk, rate_bits, COSET_SHIFT, group)
    leaves = GF(rows[:k].transpose(0, 1).contiguous())    # pad dropped
    tree = ShardedMerkleTree(leaves, cap_height, group)
    return PendingBatch(group, k, n, rate_bits, cap_height, coeffs, tree)


def grouped_trace_commitments(trace_poly_values: list, rate_bits: int,
                              cap_height: int, groups: list) -> list:
    """Per-table trace commitments: table t on group t % len(groups).

    Every group's commitments are computed before any is handed on, so the
    groups run concurrently; returns on every rank the per-table
    PolynomialBatches, identical to ``from_values``.
    """
    device = groups[0].device
    pending = [
        sharded_polynomial_batch(
            t if isinstance(t, GF) else GF.from_u64(t, device),
            rate_bits, cap_height, groups[i % len(groups)])
        for i, t in enumerate(trace_poly_values)]
    return [p.finalize() for p in pending]


def pipeline_prove_stream(stark, config, traces: list, public_inputs: list,
                          groups: list) -> list:
    """Two-stage pipelined proving of independent STARK proofs.

    Stage 1 (groups[0]): the distributed trace commitment of proof i+1.
    Stage 2 (the first rank of groups[1]): permutation Zs, quotient,
    openings and FRI of proof i, on that rank's device.  While stage 2
    proves proof i, stage 1 already commits proof i+1.

    What crosses between the groups: for each proof, one point-to-point
    send from the first rank of group 0 to the first rank of group 1 of
    the finished commitment, 8 (k n + k N + 4 (2N - 2^cap_height)) bytes
    for a (k, n) trace and N = n << rate_bits LDE rows (the coefficients,
    the leaf rows and every Merkle level, so stage 2 hashes nothing
    again).  At the end the serialized proofs are broadcast from that rank
    to every rank.  Every rank of the world must call this; each returns
    the proofs, bit-identical to ``stark.prover.prove`` run in sequence.
    """
    from ..stark.prover import prove
    from ..utils.serialization import (stark_proof_from_bytes,
                                       stark_proof_to_bytes)

    if len(groups) < 2:
        raise ValueError("the pipeline needs two device groups")
    g0, g1 = groups[0], groups[1]
    world = g0.parent
    src = world.ranks.index(g0.ranks[0])
    dst = world.ranks.index(g1.ranks[0])
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height

    blobs = None
    if g0.is_member:
        works = []
        for trace in traces:
            pending = sharded_polynomial_batch(
                GF(trace.v.to(g0.device)), rate_bits, cap_height, g0)
            flat = pending.flat()
            if g0.rank == 0:
                works += send([flat], world, dst)
        for work, _ in works:
            work.wait()
    elif world.rank == dst:
        blobs = []
        for trace, pis in zip(traces, public_inputs):
            shape = PendingBatch(g1, *trace.shape, rate_bits, cap_height)
            (flat,) = recv([(sum(shape._sizes()),)], world, src)
            proof = prove(stark, config, trace, pis, device=g1.device,
                          trace_commitment=shape.batch_from_flat(flat))
            blobs.append(stark_proof_to_bytes(proof))
    data = broadcast_bytes(pickle.dumps(blobs) if blobs is not None else None,
                           world, src=dst)
    return [stark_proof_from_bytes(b) for b in pickle.loads(data)]
