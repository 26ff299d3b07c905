"""FRI prover: commit-phase folding, proof-of-work grind, query extraction.

Twin of reference fri/prover.rs:20-216.  Folding runs in coefficient space
(a strided beta reduction) followed by a shrinking coset NTT per round, the
reference recurrence.  The PoW grind permutes batches of 2^16 candidate
states on the device (Poseidon), or hashes batches of 2^12 on the host
(the keccak config's duplex); query rounds gather Merkle paths for all
rounds at once.  Under the keccak config every commit-phase tree is a
host keccak byte-digest tree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import gl64, ntt
from ..field.extension import GF2
from ..field.goldilocks import GF, canonical, to_i64, ult
from ..field.polynomial import powers_ext
from ..hash.keccak_tree import BytesMerkleTree, _absorb_blocks
from ..hash.merkle import MerkleProof, MerkleTree
from ..hash.poseidon import permute
from ..iop.challenger import Challenger
from ..utils.bits import reverse_index_bits_perm
from ..utils.timing import TimingTree
from .config import FriConfig, FriParams
from .proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep

POW_BATCH = 1 << 16
KECCAK_POW_BATCH = 1 << 12


def _flatten_ext_leaves(values: GF2, arity: int) -> GF:
    """(m*arity,) ext values -> (m, 2*arity) base leaves, components
    interleaved per element ([a0, b0, a1, b1, ...]), as reference
    `flatten` does."""
    m = values.shape[0] // arity
    v = torch.stack([values.a.v.reshape(m, arity),
                     values.b.v.reshape(m, arity)], dim=-1)
    return GF(v.reshape(m, 2 * arity))


def _fold(coeffs: GF2, beta: GF2, arity: int, shift: int):
    """One beta fold + coset re-evaluation (fri/prover.rs:100-113):
    P(x) = sum_{i<r} x^i P_i(x^r)  =>  folded = sum_i beta^i P_i."""
    bpow = powers_ext(beta, arity)
    folded = (GF2(coeffs.a.reshape(-1, arity), coeffs.b.reshape(-1, arity))
              * bpow).sum(axis=-1)
    return folded, ntt.coset_ntt_ext(folded, shift)


def fri_committed_trees(coeffs: GF2, values: GF2, challenger: Challenger,
                        fri_params: FriParams, hasher: str = "poseidon"):
    """Commit phase (reference fri/prover.rs:69-113)."""
    tree_cls = BytesMerkleTree if hasher == "keccak" else MerkleTree
    trees = []
    shift = gl64.MULTIPLICATIVE_GROUP_GENERATOR
    device = coeffs.device
    n = values.shape[0]
    for arity_bits in fri_params.reduction_arity_bits:
        arity = 1 << arity_bits
        leaves = _flatten_ext_leaves(values.take(reverse_index_bits_perm(n)),
                                     arity)
        tree = tree_cls(leaves, fri_params.config.cap_height)
        challenger.observe_cap(tree.cap)
        trees.append(tree)

        beta_np = challenger.get_extension_challenge()
        beta = GF2.from_u64_pair(beta_np[0], beta_np[1], device)
        shift = pow(shift, arity, gl64.ORDER_INT)
        coeffs, values = _fold(coeffs, beta, arity, shift)
        n = values.shape[0]

    keep = n >> fri_params.config.rate_bits
    final_coeffs = coeffs[:keep].to_u64()   # (keep, 2); high coeffs are zero
    for c in final_coeffs:
        challenger.observe_extension_element(c)
    return trees, final_coeffs


def _keccak_pow_witness(inter: np.ndarray, pos: int, threshold: int,
                        unbounded: bool) -> np.uint64:
    """Host grind under the keccak duplex (keccak_tree.keccak_permutation_np,
    a hash onion): the response is output slot 7, word 3 of the second
    onion hash, when none of the first 8 words is rejected (probability
    ~2^-32 per word).  Rows with a rejected word are skipped, so the
    witness is the lowest candidate that passes both tests; the replay
    re-checks it."""
    offset = 0
    while True:
        states = np.broadcast_to(inter, (KECCAK_POW_BATCH, 12)).copy()
        states[:, pos] = np.arange(offset, offset + KECCAK_POW_BATCH,
                                   dtype=np.uint64)
        buf = gl64.to_canonical(states).astype("<u8").view(
            np.uint8).reshape(KECCAK_POW_BATCH, 96)
        h1 = _absorb_blocks(buf)
        h2 = _absorb_blocks(h1)
        words = np.concatenate([
            h1.reshape(-1, 4, 8).copy().view("<u8").reshape(-1, 4),
            h2.reshape(-1, 4, 8).copy().view("<u8").reshape(-1, 4),
        ], axis=1).astype(np.uint64)
        ok = (words < np.uint64(gl64.ORDER_INT)).all(axis=1)
        if not unbounded:
            ok &= words[:, 7] < np.uint64(threshold)
        hits = np.nonzero(ok)[0]
        if hits.size:
            return np.uint64(offset + int(hits[0]))
        offset += KECCAK_POW_BATCH
        if offset >= (1 << 40):
            raise RuntimeError("PoW grind failed")


def _poseidon_pow_witness(inter: np.ndarray, pos: int, threshold: int,
                          unbounded: bool, device) -> np.uint64:
    """Device grind under the Poseidon duplex: the lowest candidate whose
    response (output slot 7 of one permutation) is below the threshold."""
    base = GF.from_u64(inter, device).v.reshape(1, 12)
    offset = 0
    while True:
        states = base.repeat(POW_BATCH, 1)
        states[:, pos] = torch.arange(offset, offset + POW_BATCH,
                                      dtype=torch.int64, device=device)
        resp = canonical(permute(GF(states)).v[:, 7])
        if unbounded:
            ok = torch.ones_like(resp, dtype=torch.bool)
        else:
            ok = ult(resp, to_i64(threshold))
        hits = torch.nonzero(ok)
        if hits.numel():
            return np.uint64(offset + int(hits[0, 0]))
        offset += POW_BATCH
        if offset >= (1 << 40):
            raise RuntimeError("PoW grind failed")


def fri_proof_of_work(challenger: Challenger, config: FriConfig,
                      device, hasher: str = "poseidon") -> np.uint64:
    """Grind (reference fri/prover.rs:115-159): the lowest witness w such
    that the challenge after observing w has >= proof_of_work_bits leading
    zeros, then replayed through the host challenger.  Poseidon candidates
    are permuted on ``device``; keccak ones are hashed on the host."""
    min_lz = config.proof_of_work_bits
    threshold = 1 << (64 - min_lz)
    # the duplex state once the pending inputs are written; the witness
    # takes the next input slot
    inter = challenger.state.copy()
    pos = len(challenger.input_buffer)
    if pos:
        inter[:pos] = np.array(challenger.input_buffer, dtype=np.uint64)
    if hasher == "keccak":
        witness = _keccak_pow_witness(inter, pos, min(threshold, (1 << 64) - 1),
                                      min_lz == 0)
    else:
        witness = _poseidon_pow_witness(inter, pos, threshold, min_lz == 0,
                                        device)

    challenger.observe_element(witness)
    response = challenger.get_challenge()
    if int(response) >= threshold:
        raise RuntimeError("PoW replay mismatch")
    return witness


def fri_prover_query_rounds(initial_trees: list, trees: list,
                            challenger: Challenger, n: int,
                            fri_params: FriParams) -> list:
    """All query indices are drawn first (index draws never interleave with
    observations), then each tree is opened once for all rounds."""
    nq = fri_params.config.num_query_rounds
    x_indices = np.array([int(challenger.get_challenge()) % n
                          for _ in range(nq)], dtype=np.int64)
    initial_opens = [t.open(x_indices) for t in initial_trees]
    step_opens = []
    idx = x_indices
    for i, tree in enumerate(trees):
        idx = idx >> fri_params.reduction_arity_bits[i]
        step_opens.append(tree.open(idx))

    rounds = []
    for q in range(nq):
        initial_proof = [(leaves[q].copy(), MerkleProof(sibs[q]))
                         for leaves, sibs in initial_opens]
        steps = [FriQueryStep(leaves[q].reshape(-1, 2), MerkleProof(sibs[q]))
                 for leaves, sibs in step_opens]
        rounds.append(FriQueryRound(FriInitialTreeProof(initial_proof), steps))
    return rounds


def fri_proof(initial_merkle_trees: list, lde_polynomial_coeffs: GF2,
              lde_polynomial_values: GF2, challenger: Challenger,
              fri_params: FriParams, timing: TimingTree,
              hasher: str = "poseidon") -> FriProof:
    """Top-level FRI proof (reference fri/prover.rs:20)."""
    n = lde_polynomial_values.shape[0]
    if lde_polynomial_coeffs.shape[0] != n:
        raise ValueError("LDE coefficients and values differ in length")
    with timing.scope("commit-phase folds"):
        trees, final_coeffs = fri_committed_trees(
            lde_polynomial_coeffs, lde_polynomial_values, challenger,
            fri_params, hasher)
    with timing.scope("proof-of-work grind"):
        pow_witness = fri_proof_of_work(challenger, fri_params.config,
                                        lde_polynomial_values.device, hasher)
    with timing.scope("query rounds"):
        query_rounds = fri_prover_query_rounds(
            initial_merkle_trees, trees, challenger, n, fri_params)
    return FriProof(
        commit_phase_merkle_caps=[t.cap for t in trees],
        query_round_proofs=query_rounds,
        final_poly=final_coeffs,
        pow_witness=pow_witness,
    )
