#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (plonky2_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each:
  0. the card (nvidia-smi name and power limit), torch, CUDA and nvcc versions;
  1. build of every CUDA kernel in plonky2_tpu_torch/csrc (nvcc, sm_90a),
     with each kernel's registers, spills and SASS instructions by class;
  2. Poseidon permutation kernel against its plain torch version on 2^17
     states, noncanonical and zero states among them (exact); in phases
     2-5 the plain versions run and are timed under torch_path(), so their
     field ops are plain torch too, and results are reduced on the host;
  3. the leaf sponge's two entries, poseidon_hash_rows on (rows, L) rows
     and poseidon_hash_cols on the (L, rows) columns (digests in Merkle
     leaf order, and in column order at (2^15, 9) and (1001, 13)), each at
     1 and 16 lanes a leaf, against their plain versions (hash_no_pad_torch,
     hash_cols_torch) at (2^18 rows, 135), (2^15 rows, 9), (2^10 rows,
     2481), the zkEVM KeccakStark's trace leaves, and (1001, 13), a ragged
     length on a leaf count no block size divides (exact); the group size
     sponge_group picks at each; the column entry's ms at both group sizes
     for 2^11..2^18 leaves of 135 (the cut-over), and one leaf of 2,481
     elements alone (the chain floor);
  4. the LDE kernel (ntt.cu's lde entry) against lde_torch at the plonk
     wires' (135, 2^15) r=3, (64, 2^16) r=3, the STARK trace's (4, 2^20)
     r=1, (16, 2^8) r=3 (one pass), and the zkEVM transfer's KeccakStark
     (2481, 2^9) r=1 and MemoryStark (21, 2^21) r=1 (exact);
  5. the NTT kernel (ntt.cu) against the plain *_torch transforms: intt of
     (135, 2^15), coset_intt of (2, 2^18), coset_ntt of (2, 2^20), ntt of
     (8, 2^16), of (1, 2^23) (the three-pass plan) and coset_intt of
     (4, 2^22), the MemoryStark quotient (exact);
  5a. field: csrc/field.cu's seven entries (base add, sub, mul, neg,
     canonical; extension mul, square) against their torch versions
     (*_torch) on every pair of tests/test_torch_field.py's edge values and
     random u64 values, [p, 2^64) among them, at the same shape, a 0-d
     scalar on either side, a (k, 1) x (k, n) broadcast, strided [..., 0::2]
     / [..., 1::2] operands, rank 4 and contiguous rank 5 (equal residues
     and equal bits), and a strided rank-5 operand refused with ValueError;
     2^16- and 2^20-row Fibonacci STARK proofs through the kernels equal
     byte for byte the proofs of the torch path (torch_path(): no field.cu
     launch);
     each path's warm prove seconds and, under torch.profiler at 2^20, its
     device launches; CUDA-event ms of mul, add and the extension mul on
     2^21 elements (calls queued back to back, and one call alone)
     against the bytes bound, and the host microseconds a call of mul and
     add on one element;
  6. a 2^10-row Fibonacci STARK proved on cuda and on cpu gives the same
     proof bytes, and a wrong public result is rejected by the verifier;
  7. an m = 2 matrix-multiplication plonk proof (standard_recursion_config)
     proved on cuda and on cpu gives the same proof bytes, the verifier
     accepts it and rejects a tampered public input; an m = 2 proof under
     standard_recursion_zk_config verifies;
  8. small multi-table proofs (models/multi_table.py: the three-table CTL
     demo and Logic + Memory + a bus table) under standard_fast_config and
     under the keccak config, each proved on cuda (and, under the first,
     on cpu with equal multi_proof_to_bytes), verified, and rejected with
     a tampered CTL Z;
  9. a two-LUT lookup plonk circuit and an m = 2 matmul circuit under
     standard_keccak_config, each proved on cuda and on cpu with equal
     proof bytes and verified;
 10. the recursion slice's small cases on cuda, each proved and verified:
     a 4-query wrap of the reference tests' x^2 + y + 42 proof (also on
     cpu, equal bytes), a two-step cyclic IVC, the wrap of a 2^5-row
     Fibonacci STARK proof, the staged per-table wrappers and root of the
     three-table CTL demo, the aggregation root, a leaf aggregation and a
     first block of a two-table demo through a to_bytes /
     from_bytes(device="cuda") checkpoint, and a circuit-data checkpoint
     round trip;
 11. the STARK path at full size: a 2^20-row Fibonacci STARK under
     StarkConfig.standard_fast_config() proved twice on cuda and verified,
     with each kernel's calls and kernel launches on that path;
 12. the same prove once more under torch.profiler: device busy time, the
     device's idle share of the wall time, and device time by kernel;
 13. the plonk path at full size: the m = 64 matrix-multiplication circuit
     (degree 2^15, standard_recursion_config) built once on cuda, proved
     twice (cold, warm) and verified, with per-phase times, peak memory and
     each kernel's calls and launches on that path;
 14. the warm plonk prove once more under torch.profiler;
 15. the recursion path: models/bench_recursion.py at
     standard_recursion_config (28 queries, 16 PoW bits): a 2^12-gate inner
     proof, its level-0 wrapper and the level-1 wrapper of that, each
     wrapper built on cuda, proved cold and warm and verified, with the
     gates placed by type, per-phase times, peak memory and each kernel's
     calls and launches; proof sizes and degrees held to the JAX package's
     (126,960 and 127,440 bytes, degrees 4,096 and 8,192), the inner
     public input out of both wrappers, and a wrapper of a tampered inner
     proof rejected;
 16. the warm level-0 wrapper prove once more under torch.profiler;
 17. the zkEVM path: one transfer block (zkevm.transfer.prove_transfer,
     seven tables, arith_limb_bits=16, standard_fast_config) proved once
     with the simulation and trace-generation seconds, the table shapes,
     per-table phases and peak device memory, each kernel's calls and
     launches, the keccak backend, and verify_transfer_proof (ROM binding
     included) accepting it; in the prove each ported kernel's device time
     (CUDA events around its calls; the sponge's calls listed by entry,
     leaf count, leaf length and group size) and the device's busy share from
     nvidia-smi's utilization samples (the prove's millions of launches
     are too many for torch.profiler's parsing);
 18. the sharded phase: the distributed prover (plonky2_tpu_torch.parallel)
     on a world launched by spawn_world: min(cards, 4) ranks over NCCL on
     a machine with two or more cards, else 2 ranks on cuda:0 over gloo.
     On every rank: four_step_ntt at 2^20 points equals the single-device
     ntt; dp_lde_and_leaf_hash at (135, 2^15), rate 3, equals the
     single-device LDE and leaf hashes; the 2^20-row STARK (cold, warm,
     profiled) and the m = 64 matmul circuit (read from a checkpoint of
     phase 13's build; cold, warm) proved with mesh= give the single-device
     proof bytes of phases 11 and 13, and verify; a small circuit without
     a witness seed whose gates hold a random nonce proves with mesh= and
     verifies (every rank commits one witness); the three-table CTL demo
     proved sharded and through two device groups, and a pipelined stream
     of three 2^10-row STARKs over the two groups, give the single-device
     bytes; all_processes_equal holds on every proof's bytes.  The line gives the backend, world size,
     cards, ranks per card, collective bytes per prove, each check's
     seconds, the warm sharded and single-device prove seconds, and each
     rank's device idle share in the profiled STARK prove (under NCCL
     the collectives' own kernels count as busy), and each ported kernel's
     device ms in the warm sharded proves (CUDA events around its calls);
 19. a JSON line with every kernel's launches and device ms per prove on
     each path, times and bound.
A kernel that a path should run and that launched no time there fails the
run.  The last line is {"ok": true, "device": {...}}.  Any failure exits
non-zero before it.  Times are medians of CUDA-event timings after a
warm-up.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peaks of one H100 SXM at its full 700 W power limit: HBM3 bandwidth (NVIDIA
# data sheet), and 32-bit integer multiplies at 64 per clock per SM (the
# CUDA C++ Programming Guide's throughput table for compute capability 9.0)
# on 132 SMs at 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9


# 32-bit multiplies in one Goldilocks multiply: a 64x64->128-bit product is
# four 32x32->64-bit partial products (one IMAD.WIDE.U32 each); the
# reduction needs none (its product by 2^32 - 1 is a shift and a subtract).
# The bounds below count only these multiplies, so they are floors.
MULMOD_MULS = 4

P_INT = 2**64 - 2**32 + 1          # the Goldilocks prime


def poseidon_muls() -> dict:
    """32-bit multiplies in one Poseidon permutation, in both round
    schedules; the bound takes the lower.  S-boxes: x^7 is four Goldilocks
    multiplies, on 12 lanes in the 8 full rounds and on lane 0 in the 22
    partial rounds.  A full-round MDS: each output lane sums constant x
    32-bit half products over both halves; a constant that is a power of two
    is a shift, any other one IMAD.WIDE.U32 (constants <= 41).  The
    canonical schedule runs that MDS in all 30 rounds.  The fast one
    (reference poseidon.rs:584) runs it in the 8 full rounds only; its
    partial rounds cost an 11 x 11 matrix of full constants once, then per
    round 22 full multiplies (11 W_HATS, 11 VS) and MDS[0][0] = 25 times
    lane 0 (two halves)."""
    from plonky2_tpu_torch.hash import poseidon_constants as C

    def muls(consts):
        return sum(1 for c in consts if c & (c - 1))   # nonzero, not 2^j
    w = C.SPONGE_WIDTH
    sboxes = (C.N_FULL_ROUNDS_TOTAL * w + C.N_PARTIAL_ROUNDS) * 4 * MULMOD_MULS
    mds = 2 * (w * muls(C.MDS_MATRIX_CIRC) + muls(C.MDS_MATRIX_DIAG))
    fast_partial = ((w - 1) ** 2 * MULMOD_MULS
                    + C.N_PARTIAL_ROUNDS * (2 * (w - 1) * MULMOD_MULS + 2))
    return {"canonical": sboxes + C.N_ROUNDS * mds,
            "fast": sboxes + C.N_FULL_ROUNDS_TOTAL * mds + fast_partial}


START = time.perf_counter()


def line(phase: str, **kv) -> None:
    """One phase's JSON line; "t" is the seconds since the script began."""
    print(json.dumps({"phase": phase, **kv,
                      "t": time.perf_counter() - START}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def torch_path():
    """Every field op on CUDA tensors runs its plain torch version
    (goldilocks.run_kernel answers None, in goldilocks and in the name
    extension imported): the plain versions the kernels are held against
    contain no csrc/field.cu launch."""
    from unittest import mock

    from plonky2_tpu_torch.field import extension as ext
    from plonky2_tpu_torch.field import goldilocks as gl
    plain = lambda *args: None                          # noqa: E731
    with mock.patch.object(gl, "run_kernel", plain), \
            mock.patch.object(ext, "run_kernel", plain):
        yield


def host_residues(t: torch.Tensor) -> np.ndarray:
    """Canonical u64 values of a tensor, reduced on the host."""
    v = t.cpu().numpy().view(np.uint64)
    return np.where(v >= np.uint64(P_INT), v - np.uint64(P_INT), v)


def bound(ops: float, nbytes: float) -> tuple:
    t_ops = ops / INT32_MUL_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_abs_err(a: np.ndarray, b: np.ndarray) -> int:
    """Largest |a - b| over canonical u64 values (exact integers)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    diff = np.nonzero(fa != fb)[0]
    return max((abs(int(fa[i]) - int(fb[i])) for i in diff), default=0)


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from plonky2_tpu_torch.utils.cuda import nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    line("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())


def phase_build() -> None:
    from plonky2_tpu_torch.utils import cuda
    t0 = time.perf_counter()
    libs = cuda.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "Used", "spill"))]
             for name, log in cuda.build_log.items()}
    line("build", seconds=secs, libraries=sorted(libs), ptxas=ptxas,
         sass={name: sass_classes(path) for name, path in sorted(libs.items())})


SASS_CLASSES = ("IMAD", "IADD3", "ISETP", "SEL", "LDS", "STS", "LDG", "STG",
                "LDC", "BAR")


def sass_classes(so_path) -> dict:
    """Static count of SASS instructions by class in each kernel of a built
    library, from cuobjdump: the classes of SASS_CLASSES (by opcode, any
    suffix), "multiplies" (the IMAD forms that multiply: all but IMAD.MOV,
    IMAD.IADD and IMAD.SHL, which move, add or shift) and "total"."""
    import re
    from plonky2_tpu_torch.utils.cuda import nvcc_path
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so_path)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    op_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = re.search(r"[a-z][a-z0-9_]*_kernel", m.group(1))
            fn = name.group(0) if name else m.group(1)
            out[fn] = dict.fromkeys(SASS_CLASSES + ("multiplies", "total"), 0)
            continue
        m = op_re.search(ln)
        if not (m and fn) or m.group(1) == "NOP":
            continue
        op = m.group(1)
        counts = out[fn]
        counts["total"] += 1
        root = op.split(".")[0]
        if root in counts:
            counts[root] += 1
        if root == "IMAD" and not op.startswith(("IMAD.MOV", "IMAD.IADD", "IMAD.SHL")):
            counts["multiplies"] += 1
    return out


def phase_poseidon() -> dict:
    from plonky2_tpu_torch.hash import poseidon
    rng = np.random.default_rng(1)
    b = 1 << 17
    states = rng.integers(0, 1 << 64, size=(b, 12), dtype=np.uint64,
                          endpoint=False)
    # values in [p, 2^64) and the zero state
    states[:1024] = np.uint64(0xFFFFFFFF00000001) + rng.integers(
        0, 0xFFFFFFFF, size=(1024, 12), dtype=np.uint64)
    states[1024] = 0
    x = torch.from_numpy(states.view(np.int64)).cuda()
    got = host_residues(poseidon.permute_cuda(x))
    with torch_path():
        want = host_residues(poseidon.permute_torch(x))
    err = max_abs_err(got, want)
    if err:
        fail(f"poseidon kernel differs from permute_torch (max |err| {err})")
    ms = cuda_ms(lambda: poseidon.permute_cuda(x), reps=20)
    with torch_path():
        plain_ms = cuda_ms(lambda: poseidon.permute_torch(x), reps=3)
    muls = poseidon_muls()
    bound_ms, bound_by = bound(b * min(muls.values()), b * 12 * 8 * 2)
    line("poseidon", states=b, exact=True, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, int32_muls_per_perm=muls,
         mperms_per_s=b / ms / 1e3)
    return {"name": "poseidon_permute", "route": "cuda",
            "source": "plonky2_tpu_torch/csrc/poseidon.cu",
            "replaces": "plonky2_tpu/ops/poseidon_pallas.py:240",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def random_gf(shape, seed: int):
    from plonky2_tpu_torch.field.goldilocks import GF
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64, endpoint=False)
    return GF(torch.from_numpy(vals.view(np.int64)).cuda())


def host_canonical(x) -> np.ndarray:
    return host_residues(x.v)


def sponge_bound(rows: int, length: int) -> tuple:
    """ceil(L / 8) permutations per leaf against reading the leaves and
    writing 4 elements per leaf."""
    perms = rows * -(-length // 8)
    return bound(perms * min(poseidon_muls().values()), 8 * rows * (length + 4))


def timed_once(fn):
    """(fn(), its milliseconds by CUDA events): one call, no median."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def sponge_case(rows: int, length: int, seed: int, slow_plain: bool = False,
                orders=(True,)) -> dict:
    """Both sponge entries, at both group sizes (1 and SPONGE_GROUP lanes a
    leaf), against their plain versions on the same leaves: the row entry
    on (rows, L) rows, the column entry on the (L, rows) transpose, in each
    leaf order of ``orders`` (True: digests in Merkle leaf order).  Each
    entry's ms at each group size, the group sponge_group picks and its ms.
    The plain versions are timed by the one call that checks the kernels.
    slow_plain: the column entry is held to the row plain output gathered
    into leaf order, which is what hash_cols_torch computes (the transpose,
    the gather, hash_no_pad_torch): a leaf of 2,481 elements is 311
    sequential plain permutation calls, ~22 s."""
    from plonky2_tpu_torch.field.goldilocks import GF
    from plonky2_tpu_torch.hash import hashing
    from plonky2_tpu_torch.utils.bits import reverse_index_bits_perm
    x = random_gf((rows, length), seed).v
    cols = x.transpose(0, 1).contiguous()
    with torch_path():
        want, plain_ms = timed_once(lambda: hashing.hash_no_pad_torch(x))
    want_cols, cols_plain_ms = {}, plain_ms
    for order in orders:
        if slow_plain:
            perm = torch.as_tensor(reverse_index_bits_perm(rows), device="cuda")
            want_cols[order] = want[perm] if order else want
        else:
            with torch_path():
                want_cols[order], cols_plain_ms = timed_once(
                    lambda: hashing.hash_cols_torch(cols, 4, order))
    err = 0
    ms = {"rows": {}, "cols": {}}
    for group in (1, hashing.SPONGE_GROUP):
        err = max(err, max_abs_err(
            host_canonical(GF(hashing.hash_rows_cuda(x, group=group))),
            host_canonical(GF(want))))
        for order in orders:
            got = hashing.hash_cols_cuda(cols, 4, order, group=group)
            err = max(err, max_abs_err(host_canonical(GF(got)),
                                       host_canonical(GF(want_cols[order]))))
        if err:
            fail(f"a sponge entry differs from its plain version at "
                 f"{(rows, length)}, {group} lanes a leaf")
        ms["rows"][group] = cuda_ms(
            lambda: hashing.hash_rows_cuda(x, group=group), reps=10)
        ms["cols"][group] = cuda_ms(
            lambda: hashing.hash_cols_cuda(cols, 4, orders[0], group=group),
            reps=10)
    chosen = hashing.sponge_group(rows)
    bound_ms, bound_by = sponge_bound(rows, length)
    res = {"rows": rows, "len": length, "exact": True, "max_abs_err": err,
           "leaf_orders": list(orders), "group_chosen": chosen,
           "ms_by_group": ms, "ms": ms["rows"][chosen],
           "cols_ms": ms["cols"][chosen], "plain_ms": plain_ms,
           "cols_plain_ms": cols_plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "mperms_per_s": rows * -(-length // 8) / ms["cols"][chosen] / 1e3}
    line("hash_rows", **res)
    return res


def phase_hash_rows() -> tuple:
    """The sponge's two entries: the main-path shapes, a ragged length on
    a leaf count that no block size divides, both leaf orders, the
    cut-over between the group sizes, and the chain floor of one leaf."""
    from plonky2_tpu_torch.hash import hashing
    main = sponge_case(1 << 18, 135, seed=12)   # plonk wires' leaves
    sponge_case(1 << 15, 9, seed=13, orders=(True, False))
    sponge_case(1 << 10, 2481, seed=15,         # KeccakStark's trace leaves
                slow_plain=True)
    sponge_case(1001, 13, seed=19, orders=(False,))
    # the cut-over: the column entry at each group size, 135-element leaves
    sweep = {}
    for log_rows in range(11, 19):
        cols = random_gf((135, 1 << log_rows), 20 + log_rows).v
        sweep[1 << log_rows] = {
            group: cuda_ms(lambda: hashing.hash_cols_cuda(cols, group=group),
                           reps=5)
            for group in (1, hashing.SPONGE_GROUP)}
    # the chain floor: one leaf of 2,481 elements, 311 permutations
    one = random_gf((1, 2481), 21).v
    one_row_ms = {group: cuda_ms(lambda: hashing.hash_rows_cuda(one, group=group),
                                 reps=10)
                  for group in (1, hashing.SPONGE_GROUP)}
    line("sponge_groups", cols_ms_by_rows_len135=sweep,
         group_below_leaves=hashing.GROUP_BELOW_LEAVES,
         one_row_ms_len2481=one_row_ms)
    rows_entry = entry("poseidon_hash_rows", "plonky2_tpu_torch/csrc/poseidon.cu",
                       "plonky2_tpu/ops/poseidon_pallas.py:240", main)
    cols_entry = entry("poseidon_hash_cols", "plonky2_tpu_torch/csrc/poseidon.cu",
                       "plonky2_tpu/ops/poseidon_pallas.py:240",
                       {**main, "ms": main["cols_ms"],
                        "plain_ms": main["cols_plain_ms"]})
    return rows_entry, cols_entry


def lde_case(k: int, log_n: int, rate_bits: int, seed: int) -> dict:
    from plonky2_tpu_torch.field import ntt
    n = 1 << log_n
    x = random_gf((k, n), seed)
    before = ntt.LDE.launches
    got = ntt.lde_cuda(x, rate_bits, 7)
    launched = ntt.LDE.launches - before
    with torch_path():
        want = ntt.lde_torch(x, rate_bits, 7)
    err = max_abs_err(host_canonical(got), host_canonical(want))
    if err or launched == 0:
        fail(f"LDE kernel differs from lde_torch at {(k, n, rate_bits)}")
    ms = cuda_ms(lambda: ntt.lde_cuda(x, rate_bits, 7), reps=10)
    with torch_path():
        plain_ms = cuda_ms(lambda: ntt.lde_torch(x, rate_bits, 7), reps=3)
    big_n = n << rate_bits
    butterflies = k * (log_n) * (big_n // 2)
    ops = (butterflies + k * n) * MULMOD_MULS
    bound_ms, bound_by = bound(ops, 8 * k * n + 8 * k * big_n)
    res = {"k": k, "n": n, "rate_bits": rate_bits, "exact": True,
           "launches_per_call": launched, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "g_elems_per_s": k * big_n / ms / 1e6, "max_abs_err": err}
    line("lde", **res)
    return res


def entry(name: str, source: str, replaces: str, res: dict) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": None}


def phase_lde() -> dict:
    main = lde_case(135, 15, 3, seed=2)   # plonk wires
    lde_case(64, 16, 3, seed=3)           # bench.py's LDE shape
    lde_case(4, 20, 1, seed=4)            # the 2^20 STARK trace
    lde_case(16, 8, 3, seed=8)            # 2^11 points: one pass
    lde_case(2481, 9, 1, seed=16)         # the transfer's KeccakStark trace
    lde_case(21, 21, 1, seed=17)          # the transfer's MemoryStark trace
    e = entry("lde", "plonky2_tpu_torch/csrc/ntt.cu",
              "plonky2_tpu/ops/mxu_lde_pallas.py:304", main)
    e["also_replaces"] = ["plonky2_tpu/ops/mxu_lde3_pallas.py:249"]
    return e


def ntt_case(op: str, k: int, log_n: int, seed: int) -> dict:
    """One of the transforms through the NTT kernel against its plain
    version.  The bound counts the radix-2 butterflies' multiplies plus one
    scaling multiply per element (1/n, the coset shift or both)."""
    from plonky2_tpu_torch.field import ntt
    n = 1 << log_n
    x = random_gf((k, n), seed)
    kernel = {"ntt": lambda: ntt.ntt(x),
              "intt": lambda: ntt.intt(x),
              "coset_intt": lambda: ntt.coset_intt(x, 7),
              "coset_ntt": lambda: ntt.coset_ntt(x, 7)}[op]
    plain = {"ntt": lambda: ntt.ntt_torch(x),
             "intt": lambda: ntt.intt_torch(x),
             "coset_intt": lambda: ntt.coset_intt_torch(x, 7),
             "coset_ntt": lambda: ntt.coset_ntt_torch(x, 7)}[op]
    before = ntt.NTT.launches
    got = kernel()
    launched = ntt.NTT.launches - before
    with torch_path():
        want = plain()
    err = max_abs_err(host_canonical(got), host_canonical(want))
    if err or launched == 0:
        fail(f"NTT kernel differs from {op}_torch at {(k, n)} "
             f"(launches {launched})")
    ms = cuda_ms(kernel, reps=10)
    with torch_path():
        plain_ms = cuda_ms(plain, reps=3)
    ops = (k * (n // 2) * log_n + k * n) * MULMOD_MULS
    bound_ms, bound_by = bound(ops, 16 * k * n)
    res = {"op": op, "k": k, "n": n, "exact": True,
           "launches_per_call": launched, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "g_elems_per_s": k * n / ms / 1e6, "max_abs_err": err}
    line("ntt", **res)
    return res


def phase_ntt() -> dict:
    ntt_case("intt", 135, 15, seed=5)          # plonk wires from_values
    main = ntt_case("coset_intt", 2, 18, seed=6)   # plonk quotient
    ntt_case("coset_ntt", 2, 20, seed=7)       # STARK opening quotients
    ntt_case("ntt", 8, 16, seed=14)            # tools/pallas_ntt*.py's 2^16
    ntt_case("ntt", 1, 23, seed=11)            # the three-pass plan
    ntt_case("coset_intt", 4, 22, seed=18)     # MemoryStark's quotient
    e = entry("ntt", "plonky2_tpu_torch/csrc/ntt.cu",
              "plonky2_tpu/ops/mxu_ntt_pallas.py:203", main)
    e["also_replaces"] = ["tools/pallas_ntt_proto.py:89",
                          "tools/pallas_ntt2.py:100"]
    return e


# tests/test_torch_field.py's edge values
FIELD_EDGE = [0, 1, 2, P_INT - 1, P_INT, P_INT + 1, 2**64 - 1, 2**63,
              2**32 - 1, 2**32, 0xFFFFFFFE00000003]


def field_operands(n: int, seed: int) -> tuple:
    """Two 1-d CUDA int64 tensors: every pair of FIELD_EDGE, n random u64
    pairs, and n values in [p, 2^64) against n random ones."""
    rng = np.random.default_rng(seed)
    edge = np.array(FIELD_EDGE, dtype=np.uint64)
    ea, eb = np.meshgrid(edge, edge)
    a = np.concatenate([ea.ravel(), rng.integers(0, 1 << 64, n, dtype=np.uint64),
                        np.uint64(P_INT) + rng.integers(0, 2**32 - 1, n,
                                                        dtype=np.uint64)])
    b = np.concatenate([eb.ravel(), rng.integers(0, 1 << 64, n, dtype=np.uint64),
                        rng.integers(0, 1 << 64, n, dtype=np.uint64)])
    return tuple(torch.from_numpy(v.view(np.int64).copy()).cuda() for v in (a, b))


def field_shapes(a, b, k: int = 7) -> dict:
    """Operand pairs of every layout the entries take, from two 1-d tensors."""
    n = (a.numel() // (4 * k)) * 4
    a2, b2 = a[:k * n].reshape(k, n), b[:k * n].reshape(k, n)
    r4 = (2, 3, 4, n // 8)
    r5 = (2, 3, 2, 2, n // 8)
    m = int(np.prod(r4))
    return {"same": (a, b),
            "scalar": (a, b[5].clone()),
            "scalar_left": (a[5].clone(), b),
            "broadcast_k1": (a2, b[:k].reshape(k, 1)),
            "broadcast_k1_left": (b[:k].reshape(k, 1), a2),
            "strided": (a2[..., 0::2], a2[..., 1::2]),
            "strided_b": (b2[..., 1::2], a2[..., 0::2]),
            "rank4": (a[:m].reshape(r4), b[:m].reshape(r4)),
            "rank5_contiguous": (a[:m].reshape(r5), b[:m].reshape(r5)),
            "rank4_permuted": (a[:m].reshape(r4).transpose(0, 3),
                               b[:m].reshape(2, 4, 3, n // 8)
                               .permute(3, 2, 1, 0))}


def field_check(name: str, got: list, want: list) -> None:
    """Fails unless each output equals its torch version's in residue and in
    bits, at the torch version's shape."""
    for g, w in zip(got, want):
        if tuple(g.shape) != tuple(w.shape):
            fail(f"field {name}: shape {tuple(g.shape)} against {tuple(w.shape)}")
        if not np.array_equal(host_residues(g), host_residues(w)):
            fail(f"field {name}: residues differ from the torch version")
        if not torch.equal(g, w):
            fail(f"field {name}: bits differ from the torch version")


def field_prove(log_rows: int, kernels: list, profiled: bool) -> dict:
    """A Fibonacci STARK proved through the field kernels and through the
    torch path (torch_path()), warm; the two proofs' bytes must be equal,
    and only the kernel path may launch field.cu entries."""
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.utils.serialization import stark_proof_to_bytes
    config = StarkConfig.standard_fast_config()
    stark, trace, pis, _ = fib_inputs(log_rows)
    run = lambda: prove(stark, config, trace, pis)     # noqa: E731
    res = {"rows": 1 << log_rows}
    proofs = {}
    for path in ("kernels", "torch"):
        with torch_path() if path == "torch" else contextlib.nullcontext():
            run()                                      # warm-up
            torch.cuda.synchronize()
            for k in kernels:
                k.reset()
            t0 = time.perf_counter()
            proof = run()
            torch.cuda.synchronize()
            res[f"{path}_prove_s"] = time.perf_counter() - t0
            res[f"{path}_calls"] = {k.symbol: k.calls for k in kernels}
            proofs[path] = stark_proof_to_bytes(proof)
            if profiled:
                prof = profile_prove(run, [])
                res[f"{path}_device_launches"] = prof["device_launches"]
                res[f"{path}_device_busy_ms"] = prof["device_busy_ms"]
                res[f"{path}_wall_ms_profiled"] = prof["wall_ms_profiled"]
    if proofs["kernels"] != proofs["torch"]:
        fail(f"2^{log_rows} proof bytes differ between the field kernels "
             "and the torch path")
    if not any(res["kernels_calls"].values()) or any(res["torch_calls"].values()):
        fail(f"field.cu calls {res['kernels_calls']} on the kernel path and "
             f"{res['torch_calls']} on the torch path of the 2^{log_rows} prove")
    res["proof_bytes"] = len(proofs["kernels"])
    res["bytes_equal"] = True
    return res


def field_device_ms(fn, reps: int = 50, host_us: float = 60) -> float:
    """Device milliseconds a call of fn by CUDA events around reps calls
    queued behind a spin kernel: a field op's host enqueue (~25 us) outlasts
    its kernel at 2^21 elements, so timed one by one the device would wait
    on the host between launches.  host_us: the most a call takes to
    enqueue, which the spin covers."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.98e9 * reps * host_us * 1e-6))   # calls queue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def field_host_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of fn (its enqueue), after a warm-up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_field() -> None:
    """csrc/field.cu against the torch versions, two proofs on both paths,
    and the entries' times (module docstring, phase 5a)."""
    from plonky2_tpu_torch.field import extension as ext
    from plonky2_tpu_torch.field import goldilocks as gl
    from plonky2_tpu_torch.field.extension import GF2
    from plonky2_tpu_torch.field.goldilocks import GF
    kernels = [gl.ADD, gl.SUB, gl.MUL, gl.NEG, gl.CANONICAL, ext.MUL, ext.SQUARE]
    for k in kernels:
        k.reset()
    a, b = field_operands(400, seed=21)
    shapes = field_shapes(a, b)
    for name, (x, y) in shapes.items():
        for op in ("add", "sub", "mul"):
            field_check(f"{op} {name}", [getattr(gl, op)(x, y)],
                        [getattr(gl, f"{op}_torch")(x, y)])
        for op in ("neg", "canonical"):
            for v in (x, y):
                field_check(f"{op} {name}", [getattr(gl, op)(v)],
                            [getattr(gl, f"{op}_torch")(v)])
        # the second factor's components swap the roles of x and y
        u, w = GF2(GF(x), GF(y)), GF2(GF(y), GF(x))
        want_mul, want_square = ext.mul_torch(u, w), ext.square_torch(u)
        got = u * w
        field_check(f"gl2 mul {name}", [got.a.v, got.b.v],
                    [want_mul.a.v, want_mul.b.v])
        got = u.square()
        field_check(f"gl2 square {name}", [got.a.v, got.b.v],
                    [want_square.a.v, want_square.b.v])
    calls = {k.symbol: k.calls for k in kernels}
    if not all(calls.values()):
        fail(f"field entries not all taken: calls {calls}")
    x5 = shapes["rank5_contiguous"][0].transpose(0, 4)
    try:
        gl.add(x5, x5)
        fail("a strided rank-5 operand on CUDA did not raise")
    except ValueError as e:
        refused = str(e)
    proofs = [field_prove(16, kernels, profiled=False),
              field_prove(20, kernels, profiled=True)]
    n = 1 << 21
    x, y, z, t = (random_gf((n,), seed) for seed in (22, 23, 24, 25))
    u, w = GF2(x, y), GF2(z, t)
    timed = {}
    for name, fn, plain, nbytes in (
            ("mul", lambda: x * y, lambda: gl.mul_torch(x.v, y.v), 24 * n),
            ("add", lambda: x + y, lambda: gl.add_torch(x.v, y.v), 24 * n),
            ("gl2_mul", lambda: u * w, lambda: ext.mul_torch(u, w), 48 * n)):
        ms = field_device_ms(fn)
        with torch_path():
            plain_ms = field_device_ms(plain, reps=10, host_us=3000)
        timed[name] = {"elements": n, "ms": ms, "ms_one_call": cuda_ms(fn),
                       "plain_ms": plain_ms,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes"}
        timed[name]["roofline_share"] = timed[name]["bound_ms"] / ms
    one = random_gf((1,), 26)
    host_us = {"mul_kernel": field_host_us(lambda: one * one),
               "mul_torch": field_host_us(lambda: gl.mul_torch(one.v, one.v)),
               "add_kernel": field_host_us(lambda: one + one),
               "add_torch": field_host_us(lambda: gl.add_torch(one.v, one.v))}
    line("field", shapes=sorted(shapes), exact=True, bits_equal=True,
         refused=refused, calls=calls, proofs=proofs, timed_2p21=timed, host_us_per_call=host_us)


def fib_inputs(log_rows: int, x0: int = 0, x1: int = 1):
    from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
    stark = FibonacciStark(1 << log_rows)
    t0 = time.perf_counter()
    trace = stark.generate_trace(x0, x1)
    pis = np.array([x0, x1, stark.expected_result(x0, x1)], dtype=np.uint64)
    return stark, trace, pis, time.perf_counter() - t0


def phase_small_proofs() -> None:
    from plonky2_tpu_torch.field import gl64
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    from plonky2_tpu_torch.utils.serialization import stark_proof_to_bytes
    config = StarkConfig.standard_fast_config()
    stark, trace, pis, _ = fib_inputs(10)
    on_gpu = stark_proof_to_bytes(prove(stark, config, trace, pis))
    on_cpu = stark_proof_to_bytes(prove(stark, config, trace, pis, device="cpu"))
    if on_gpu != on_cpu:
        fail("2^10 proof bytes differ between cuda and cpu")
    verify_stark_proof(stark, prove(stark, config, trace, pis), config, 10)
    bad = pis.copy()
    bad[2] = np.uint64((int(bad[2]) + 1) % gl64.ORDER_INT)
    try:
        verify_stark_proof(stark, prove(stark, config, trace, bad), config, 10)
    except AssertionError:
        rejected = True
    else:
        rejected = False
    if not rejected:
        fail("a wrong public result was accepted")
    line("small_proofs", rows=1 << 10, bytes=len(on_gpu),
         cuda_equals_cpu=True, wrong_result_rejected=True)


def matmul_inputs(m: int, seed: int):
    from plonky2_tpu_torch.field import gl64
    rng = np.random.default_rng(seed)
    return (rng.integers(0, gl64.ORDER_INT, size=(m, m), dtype=np.uint64),
            rng.integers(0, gl64.ORDER_INT, size=(m, m), dtype=np.uint64))


def phase_small_plonk() -> None:
    """m = 2 matmul plonk proofs: cuda and cpu bytes equal, the verifier
    accepts and rejects a tampered public input; a zk proof verifies."""
    from plonky2_tpu_torch.field import gl64
    from plonky2_tpu_torch.models.matrix_mul import (build_matrix_mul_circuit,
                                                     matrix_mul_witness)
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.utils.serialization import proof_with_pis_to_bytes
    a, b = matmul_inputs(2, seed=9)
    proofs, datas = {}, {}
    for device in ("cuda", "cpu"):
        data, at, bt = build_matrix_mul_circuit(2, device=device)
        data.prover_only.schedule.rng_seed = 1    # the PI gate's random wires
        proofs[device] = data.prove(matrix_mul_witness(at, bt, a, b))
        datas[device] = data
    on_gpu = proof_with_pis_to_bytes(proofs["cuda"])
    if on_gpu != proof_with_pis_to_bytes(proofs["cpu"]):
        fail("m = 2 plonk proof bytes differ between cuda and cpu")
    if not np.array_equal(datas["cuda"].verifier_only.circuit_digest,
                          datas["cpu"].verifier_only.circuit_digest):
        fail("m = 2 circuit digests differ between cuda and cpu")
    datas["cuda"].verify(proofs["cuda"])
    proof = proofs["cuda"]
    proof.public_inputs = proof.public_inputs.copy()
    proof.public_inputs[2] = (int(proof.public_inputs[2]) + 1) % gl64.ORDER_INT
    try:
        datas["cuda"].verify(proof)
    except AssertionError:
        pass
    else:
        fail("a tampered plonk public input was accepted")
    zk_data, at, bt = build_matrix_mul_circuit(
        2, CircuitConfig.standard_recursion_zk_config(), device="cuda")
    t0 = time.perf_counter()
    zk_proof = zk_data.prove(matrix_mul_witness(at, bt, a, b))
    torch.cuda.synchronize()
    zk_secs = time.perf_counter() - t0
    zk_data.verify(zk_proof)
    line("small_plonk", m=2, bytes=len(on_gpu), cuda_equals_cpu=True,
         tampered_public_input_rejected=True, zk_degree=zk_data.common.degree(),
         zk_prove_seconds=zk_secs, zk_verified=True)


def phase_small_multi(devices=("cuda", "cpu")) -> None:
    """The three-table CTL demo and the Logic + Memory + bus demo
    (models/multi_table.py) under the Poseidon and the keccak configs:
    proved on cuda, and under the Poseidon config also on cpu with equal
    multi_proof_to_bytes (the keccak config's cpu twins were cut to keep
    the run inside its time; tests/test_torch_multi.py holds both hashers'
    bytes against the JAX package on the CPU), accepted by the verifier,
    and rejected once the looked table's final CTL product is tampered
    with."""
    from plonky2_tpu_torch.field import gl64
    from plonky2_tpu_torch.models.multi_table import ctl_demo, zkevm_bus_demo
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.multi import (prove_multi_table,
                                               verify_multi_table)
    from plonky2_tpu_torch.zkevm.serialization import multi_proof_to_bytes
    sizes = {}
    for name, demo in (("ctl_demo", ctl_demo),
                       ("zkevm_bus_demo", zkevm_bus_demo)):
        for hasher in ("poseidon", "keccak"):
            starks, ctls, traces = demo()
            config = StarkConfig(hasher=hasher)
            twins = devices if hasher == "poseidon" else devices[:1]
            proofs = [prove_multi_table(starks, ctls, config, traces,
                                        device=d) for d in twins]
            data = [multi_proof_to_bytes(p, hasher) for p in proofs]
            if data[0] != data[-1]:
                fail(f"{name} proof bytes under {hasher} differ between "
                     f"{twins[0]} and {twins[-1]}")
            proof = proofs[0]
            verify_multi_table(starks, ctls, proof, config)
            last = proof.stark_proofs[0].openings.ctl_zs_last
            last[0] = gl64.add(last[0], np.uint64(1))
            try:
                verify_multi_table(starks, ctls, proof, config)
            except AssertionError:
                pass
            else:
                fail(f"{name}: a tampered CTL Z was accepted under {hasher}")
            sizes[f"{name}/{hasher}"] = len(data[0])
    line("small_multi", proof_bytes=sizes, cuda_equals_cpu="poseidon",
         verified=True, tampered_ctl_z_rejected=True)


TIP5_IN = list(range(8))
TIP5_OUT = [y & 0xFFFF for y in (0xDEAD, 0xBEEF, 17, 255, 0, 3, 7, 8)]


def two_luts_circuit(device):
    """The reference package's two-LUT lookup circuit (its
    tests/test_lookup.py): y = TIP5[x], s = (7^2 + 1), y + s public."""
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.plonk.builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    b = CircuitBuilder(CircuitConfig(fri_config=FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
        num_query_rounds=4)))
    lut_a = b.add_lookup_table_from_table(TIP5_IN, TIP5_OUT)
    lut_b = b.add_lookup_table_from_fn(lambda x: (x * x + 1) & 0xFFFF,
                                       list(range(16)))
    x = b.add_virtual_target()
    y = b.add_lookup_from_index(x, lut_a)
    s = b.add_lookup_from_index(b.constant(7), lut_b)
    b.register_public_inputs([x, y, s, b.add(y, s)])
    return b.build(device), x


def phase_small_plonk_extra(devices=("cuda", "cpu")) -> None:
    """A lookup circuit and an m = 2 matmul circuit under
    standard_keccak_config, each proved on cuda and on cpu with equal
    proof bytes and verified."""
    from plonky2_tpu_torch.models.matrix_mul import (build_matrix_mul_circuit,
                                                     matrix_mul_witness)
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.witness import PartialWitness
    from plonky2_tpu_torch.utils.serialization import proof_with_pis_to_bytes
    a, b = matmul_inputs(2, seed=19)
    out = {}
    for name in ("two_luts", "matmul_m2_keccak"):
        data_bytes = []
        for device in devices:
            if name == "two_luts":
                data, x = two_luts_circuit(device)
                pw = PartialWitness()
                pw.set_target(x, 6)
            else:
                data, at, bt = build_matrix_mul_circuit(
                    2, CircuitConfig.standard_keccak_config(), device=device)
                pw = matrix_mul_witness(at, bt, a, b)
            data.prover_only.schedule.rng_seed = 1   # the PI gate's wires
            proof = data.prove(pw)
            data.verify(proof)
            data_bytes.append(proof_with_pis_to_bytes(proof))
        if name == "two_luts" and \
                list(map(int, proof.public_inputs)) != [6, 7, 50, 57]:
            fail("the lookup circuit's public inputs are wrong")
        if data_bytes[0] != data_bytes[-1]:
            fail(f"{name} proof bytes differ between {devices[0]} and "
                 f"{devices[-1]}")
        out[name] = len(data_bytes[0])
    line("small_plonk_extra", proof_bytes=out, cuda_equals_cpu=True,
         verified=True)


def run_path(path: str, prove, kernels: list, required: list) -> dict:
    """prove(timing) twice (cold, warm), each with every kernel count set to
    0 just before it and read just after; fails if a kernel of the path
    launched no time in the warm run."""
    from plonky2_tpu_torch.utils.timing import TimingTree
    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.reset()
        timing = TimingTree("prove", "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prove(timing)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        calls = {k.symbol: k.calls for k in kernels}
        timing.close()
        runs.append({"seconds": secs, "launches": launches, "calls": calls,
                     "timing": timing.as_dict(),
                     "max_memory_allocated": torch.cuda.max_memory_allocated()})
    for k in required:
        if runs[-1]["launches"][k.symbol] == 0:
            fail(f"kernel {k.symbol} was not launched on the {path} path")
    return {"proof": proof, "cold": runs[0], "warm": runs[1]}


def phase_full_prove(kernels: list, required: list):
    """The 2^20-row STARK path; returns each kernel's launches on it and
    its inputs."""
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    config = StarkConfig.standard_fast_config()
    stark, trace, pis, trace_s = fib_inputs(20)
    res = run_path("stark", lambda timing: prove(stark, config, trace, pis,
                                                timing=timing),
                   kernels, required)
    verify_stark_proof(stark, res["proof"], config, 20)
    warm = res["warm"]
    line("full_prove", rows=1 << 20, trace_generation_seconds=trace_s,
         prove_seconds_cold=res["cold"]["seconds"],
         prove_seconds_warm=warm["seconds"],
         calls=warm["calls"], launches=warm["launches"],
         max_memory_allocated=warm["max_memory_allocated"],
         timing=warm["timing"], verified=True)
    from plonky2_tpu_torch.utils.serialization import stark_proof_to_bytes
    ref = {"bytes": stark_proof_to_bytes(res["proof"]),
           "warm_seconds": warm["seconds"]}
    return warm["launches"], lambda: prove(stark, config, trace, pis), ref


def phase_plonk(kernels: list, required: list):
    """The m = 64 matmul plonk path: build once, prove twice, verify; returns
    each kernel's launches on it and the warm prove."""
    from plonky2_tpu_torch.models.matrix_mul import (build_matrix_mul_circuit,
                                                     expected_product,
                                                     matrix_mul_witness)
    m = 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data, at, bt = build_matrix_mul_circuit(m, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_mem = torch.cuda.max_memory_allocated()
    data.prover_only.schedule.rng_seed = 1    # the PI gate's random wires
    a, b = matmul_inputs(m, seed=10)
    pw = matrix_mul_witness(at, bt, a, b)
    res = run_path("plonk", lambda timing: data.prove(pw, timing), kernels,
                   required)
    proof = res["proof"]
    t0 = time.perf_counter()
    data.verify(proof)
    verify_s = time.perf_counter() - t0
    c = proof.public_inputs.reshape(m, m, 3)[:, :, 2]
    if not np.array_equal(c, expected_product(a, b)):
        fail("the m = 64 proof's public product differs from A * B")
    warm = res["warm"]
    line("plonk_prove", m=m, degree=data.common.degree(),
         gates=[g.id() for g in data.common.gates],
         build_seconds=build_s, build_max_memory_allocated=build_mem,
         prove_seconds_cold=res["cold"]["seconds"],
         prove_seconds_warm=warm["seconds"], verify_seconds=verify_s,
         calls=warm["calls"], launches=warm["launches"],
         max_memory_allocated=warm["max_memory_allocated"],
         timing=warm["timing"], verified=True, product_checked=True)
    from plonky2_tpu_torch.utils.serialization import (circuit_data_to_bytes,
                                                       proof_with_pis_to_bytes)
    ref = {"bytes": proof_with_pis_to_bytes(proof),
           "warm_seconds": warm["seconds"],
           "circuit": (circuit_data_to_bytes(data), at, bt)}
    return warm["launches"], lambda: data.prove(pw), ref


# The reference package's tests/test_zkevm_transfer.py _base_inputs(): sender
# A holds 10^18 wei at nonce 5 and sends 4 * 10^15 wei to a fresh account B
# at gas price 10, in block 1 with a coinbase.
SENDER = bytes.fromhex("a94f5374fce5edbc8e2a8697c15331677e6ebf0b")
RECIPIENT = bytes.fromhex("095e7baea6a6c7c4c2dfeb977efac326af552d87")
COINBASE = bytes.fromhex("2adc25665018aa1fe0e6bc666dac8fc2697ff9ba")

# (columns, rows) of the seven tables of that block at arith_limb_bits=16
TRANSFER_TABLES = {"CpuStark": (139, 1 << 19), "MemoryStark": (21, 1 << 21),
                   "LogicStark": (523, 1 << 11),
                   "ArithmeticStark": (303, 1 << 16),
                   "KeccakSpongeStark": (413, 1 << 5),
                   "KeccakStark": (2481, 1 << 9),
                   "ProgramStark": (11, 1 << 15)}


def transfer_inputs():
    from plonky2_tpu_torch.zkevm import mpt
    from plonky2_tpu_torch.zkevm.transfer import (BlockMetadata,
                                                  GenerationInputs, Transfer)
    state = mpt.trie_insert(mpt.Empty(), mpt.state_key(SENDER),
                            mpt.Account(nonce=5, balance=10 ** 18).encode())
    return GenerationInputs(
        txn=Transfer(sender=SENDER, to=RECIPIENT, value=4 * 10 ** 15,
                     nonce=5, gas_price=10),
        tries=mpt.TrieInputs(state_trie=state),
        block_metadata=BlockMetadata(beneficiary=COINBASE, number=1,
                                     timestamp=1_000_000))


class TablePeaks:
    """Peak device memory of each table's prove, and of the trace
    commitments and CTL data before the first table: wraps
    stark.multi.prove_single_table and resets the peak at each table's
    start and end, so each interval's peak is read on its own."""

    def __init__(self):
        from plonky2_tpu_torch.stark import multi
        self.multi = multi
        self.original = multi.prove_single_table
        self.peaks = {}

    def _measured(self, stark, *args, **kwargs):
        torch.cuda.synchronize()
        if not self.peaks:
            self.peaks["trace commitments + CTL data"] = \
                torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        proof = self.original(stark, *args, **kwargs)
        torch.cuda.synchronize()
        self.peaks[type(stark).__name__] = torch.cuda.max_memory_allocated()
        return proof

    def __enter__(self):
        self.multi.prove_single_table = self._measured
        return self

    def __exit__(self, *exc):
        self.multi.prove_single_table = self.original


class KernelEvents:
    """Each ported kernel call's device time, by CUDA events recorded just
    before and after it on its stream, while the context is open (it wraps
    CudaKernel.__call__); cheap enough for any prove, where torch.profiler
    is not."""

    def __init__(self, kernels: list):
        from plonky2_tpu_torch.utils.cuda import CudaKernel
        self.kernel_cls = CudaKernel
        self.call = CudaKernel.__call__
        self.events = {k.symbol: [] for k in kernels}

    def _timed_call(self, kernel, *args):
        if kernel.symbol not in self.events:      # csrc/field.cu's entries
            return self.call(kernel, *args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.call(kernel, *args)
        end.record()
        self.events[kernel.symbol].append((start, end, args))

    def __enter__(self):
        self.kernel_cls.__call__ = \
            lambda kernel, *a: self._timed_call(kernel, *a)
        return self

    def __exit__(self, *exc):
        self.kernel_cls.__call__ = self.call

    def kernel_ms(self) -> dict:
        torch.cuda.synchronize()
        return {sym: sum(s.elapsed_time(e) for s, e, _ in evs)
                for sym, evs in self.events.items()}

    def sponge_calls(self) -> list:
        """The sponge's calls by entry and (leaves, leaf length, lanes a
        leaf): their count and device ms, most ms first."""
        import collections
        torch.cuda.synchronize()
        shapes = {"poseidon_hash_rows": lambda a: (a[2], a[3], a[5]),
                  "poseidon_hash_cols": lambda a: (a[3], a[2], a[7])}
        calls, ms = collections.Counter(), collections.Counter()
        for sym, shape in shapes.items():
            for s, e, args in self.events.get(sym, []):
                key = (sym,) + shape(args)
                calls[key] += 1
                ms[key] += s.elapsed_time(e)
        return [{"entry": k[0], "leaves": k[1], "len": k[2], "group": k[3],
                 "calls": calls[k], "ms": t} for k, t in ms.most_common()]


class ProveWindow:
    """Device measurements of the multi-table prove inside prove_transfer
    (simulation and trace generation excluded), for a prove too large for
    torch.profiler (millions of launches: its event parsing did not finish
    in 10 minutes): each ported kernel call's device time (KernelEvents),
    and nvidia-smi's utilization.gpu (the share of each sample period in
    which a kernel ran) every 100 ms.  Wraps zkevm.generation's
    prove_multi_table."""

    def __init__(self, kernels: list):
        from plonky2_tpu_torch.zkevm import generation
        self.generation = generation
        self.prove = generation.prove_multi_table
        self.kernels = KernelEvents(kernels)
        self.samples = []

    def _measured_prove(self, *args, **kwargs):
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        try:
            with self.kernels:
                proof = self.prove(*args, **kwargs)
                torch.cuda.synchronize()
        finally:
            smi.terminate()
            out, _ = smi.communicate(timeout=30)
        self.samples = [float(x) for x in out.split()]
        return proof

    def __enter__(self):
        self.generation.prove_multi_table = self._measured_prove
        return self

    def __exit__(self, *exc):
        self.generation.prove_multi_table = self.prove


def phase_zkevm_transfer(kernels: list, required: list):
    """The zkEVM path: one transfer block through zkevm.transfer.prove_transfer
    at arith_limb_bits=16 under standard_fast_config, once (earlier paths
    have built and run every kernel; a second, warm prove was cut to keep
    the run inside its time), with every kernel count set to 0 just before
    it and read just after, inside a ProveWindow; the seven table shapes
    checked; verify_transfer_proof (ROM binding included) must accept.
    Returns the run's launches and its kernels' device ms."""
    from plonky2_tpu_torch import native
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.utils.timing import TimingTree
    from plonky2_tpu_torch.zkevm.transfer import (prove_transfer,
                                                  verify_transfer_proof)
    inputs = transfer_inputs()
    config = StarkConfig.standard_fast_config()
    window = ProveWindow(kernels)
    for k in kernels:
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    timing = TimingTree("prove_transfer", "cuda")
    t0 = time.perf_counter()
    with TablePeaks() as peaks, window:
        proof, starks, ctls, pv = prove_transfer(inputs, config, timing=timing)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    timing.close()
    generate, prove = timing.children
    launches = {k.symbol: k.launches for k in kernels}
    kernel_ms = window.kernels.kernel_ms()
    if not window.samples:
        fail("nvidia-smi gave no utilization samples during the prove")
    utilization = statistics.mean(window.samples) / 100
    for k in required:
        if launches[k.symbol] == 0:
            fail(f"kernel {k.symbol} was not launched on the zkevm_transfer "
                 "path")
    shapes = {type(s).__name__: (s.COLUMNS, 1 << p.degree_bits)
              for s, p in zip(starks, proof.stark_proofs)}
    if shapes != TRANSFER_TABLES:
        fail(f"transfer tables {shapes} differ from {TRANSFER_TABLES}")
    t0 = time.perf_counter()
    verify_transfer_proof(starks, ctls, proof, pv, config)
    verify_s = time.perf_counter() - t0
    line("zkevm_transfer", arith_limb_bits=16, tables=shapes,
         trace_bytes=sum(8 * c * n for c, n in shapes.values()),
         simulate_and_trace_seconds=generate.duration(),
         prove_seconds=prove.duration(), prove_transfer_seconds=secs,
         verify_seconds=verify_s, verified=True, rom_binding_checked=True,
         keccak_backend=native.backend(),
         calls={k.symbol: k.calls for k in kernels}, launches=launches,
         kernel_device_ms=kernel_ms, sponge_calls=window.kernels.sponge_calls(),
         utilization_samples=len(window.samples),
         device_busy_share_smi=utilization,
         device_idle_share_smi=1 - utilization,
         max_memory_allocated=max(peaks.peaks.values()),
         peak_memory_by_table=peaks.peaks, timing=prove.as_dict())
    return launches, kernel_ms


# The JAX package's proof sizes at standard_recursion_config for
# bench_recursion's 2^12-gate inner proof and its level-0 wrapper, and each
# wrapper level's degree: the level-1 wrapper places 4,137 gates (the JAX
# package's gadgets place the same, tests/test_torch_recursion.py), so it
# pads to 2^13.  None of these depends on the device.
RECURSION_INNER_BYTES = 126_960
RECURSION_WRAPPER_BYTES = 127_440
RECURSION_WRAPPER_DEGREES = (1 << 12, 1 << 13)


def phase_recursion(kernels: list, required: list):
    """The recursion path: bench_recursion at standard_recursion_config.
    The 2^12-gate inner circuit is built, proved and verified on cuda; then
    the level-0 wrapper (verifying the inner proof) and the level-1 wrapper
    (verifying the level-0 proof) are each built on cuda, proved cold and
    warm through run_path and verified.  The proof sizes and degrees are
    checked against the JAX package's, the inner public input must come out
    of both wrappers, and a level-0 witness made from a tampered inner proof
    must give a proof the verifier rejects.  Returns the level-0 warm
    prove's launches and a warm level-0 prove."""
    import collections
    from plonky2_tpu_torch.models.bench_recursion import (add_wrapper_gates,
                                                          dummy_inner,
                                                          recursion_config,
                                                          wrapper_witness)
    from plonky2_tpu_torch.plonk.builder import CircuitBuilder
    from plonky2_tpu_torch.utils.serialization import proof_with_pis_to_bytes
    config = recursion_config()
    t0 = time.perf_counter()
    data, pw = dummy_inner(config, 12, device="cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = data.prove(pw)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    data.verify(proof)
    size = len(proof_with_pis_to_bytes(proof))
    if size != RECURSION_INNER_BYTES:
        fail(f"inner proof is {size} bytes, not {RECURSION_INNER_BYTES}")
    if [int(v) for v in proof.public_inputs] != [42]:
        fail("the inner proof's public input is not 42")
    line("recursion_inner", degree=data.common.degree(), build_seconds=build_s,
         prove_seconds=prove_s, proof_bytes=size, verified=True)
    inner = (data, proof)
    level0 = None
    for level in (0, 1):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = CircuitBuilder(config)
        pt, vdt = add_wrapper_gates(b, data.common)
        gates = collections.Counter(type(g).__name__
                                    for g, _ in b.gate_instances)
        outer = b.build("cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_mem = torch.cuda.max_memory_allocated()
        if outer.common.degree() != RECURSION_WRAPPER_DEGREES[level]:
            fail(f"level-{level} wrapper has degree {outer.common.degree()}")
        wpw = wrapper_witness(pt, vdt, proof, data.verifier_only)
        res = run_path(f"recursion level {level}",
                       lambda timing: outer.prove(wpw, timing), kernels,
                       required)
        t0 = time.perf_counter()
        outer.verify(res["proof"])
        verify_s = time.perf_counter() - t0
        size = len(proof_with_pis_to_bytes(res["proof"]))
        if level == 0 and size != RECURSION_WRAPPER_BYTES:
            fail(f"level-0 wrapper proof is {size} bytes, not "
                 f"{RECURSION_WRAPPER_BYTES}")
        if [int(v) for v in res["proof"].public_inputs] != [42]:
            fail(f"the level-{level} wrapper does not expose the inner "
                 "public input")
        warm = res["warm"]
        line("recursion_wrap", level=level, degree=outer.common.degree(),
             gates_placed=dict(gates.most_common()),
             gates=[g.id() for g in outer.common.gates],
             build_seconds=build_s, build_max_memory_allocated=build_mem,
             proof_bytes=size, prove_seconds_cold=res["cold"]["seconds"],
             prove_seconds_warm=warm["seconds"], verify_seconds=verify_s,
             calls=warm["calls"], launches=warm["launches"],
             max_memory_allocated=warm["max_memory_allocated"],
             timing=warm["timing"], verified=True)
        if level == 0:
            level0 = (outer, pt, vdt, wpw, warm["launches"])
        data, proof = outer, res["proof"]

    outer, pt, vdt, wpw, launches = level0
    inner_data, inner_proof = inner
    tampered = type(inner_proof)(
        inner_proof.proof, np.array(inner_proof.public_inputs, np.uint64))
    tampered.public_inputs[0] += np.uint64(1)
    try:
        outer.verify(outer.prove(wrapper_witness(
            pt, vdt, tampered, inner_data.verifier_only)))
    except AssertionError:
        pass
    else:
        fail("a wrapper of a tampered inner proof was accepted")
    line("recursion_tampered", tampered_inner_rejected=True)
    return launches, lambda: outer.prove(wpw)


def phase_small_recursion() -> None:
    """The recursion slice's small cases on cuda, each proved and verified:
    the 4-query wrap (the reference tests' x^2 + y + 42 inner circuit),
    also on cpu with equal proof bytes; a two-step cyclic IVC; the wrap of a
    2^5-row Fibonacci STARK proof; the staged per-table wrappers and root of
    the three-table CTL demo; the aggregation root, a leaf aggregation and
    a first block of the two-table demo through a to_bytes /
    from_bytes(device="cuda") checkpoint; a circuit-data checkpoint round
    trip."""
    from plonky2_tpu_torch.models.bench_recursion import (build_wrapper,
                                                          recursion_config,
                                                          wrapper_witness)
    from plonky2_tpu_torch.utils.serialization import proof_with_pis_to_bytes
    config = recursion_config(4, 8)
    t0 = time.perf_counter()
    out = {}
    for device in ("cuda", "cpu"):
        inner, pw = small_inner(config, device)
        inner.prover_only.schedule.rng_seed = 1
        inner_proof = inner.prove(pw)
        outer, pt, vdt = build_wrapper(config, inner.common, device)
        outer.prover_only.schedule.rng_seed = 1
        out[device] = outer.prove(wrapper_witness(pt, vdt, inner_proof,
                                                  inner.verifier_only))
        if device == "cuda":
            outer.verify(out[device])
    wrap = proof_with_pis_to_bytes(out["cuda"])
    if wrap != proof_with_pis_to_bytes(out["cpu"]):
        fail("4-query wrapper proof bytes differ between cuda and cpu")
    line("small_wrap", degree=outer.common.degree(), proof_bytes=len(wrap),
         cuda_equals_cpu=True, verified=True,
         seconds=time.perf_counter() - t0)
    for name, case in (("small_cyclic", small_cyclic),
                       ("small_stark_wrap", small_stark_wrap),
                       ("small_staged", small_staged),
                       ("small_aggregation", small_aggregation),
                       ("small_checkpoint", small_checkpoint)):
        t0 = time.perf_counter()
        facts = case()
        line(name, **facts, seconds=time.perf_counter() - t0)


def small_inner(config, device):
    """The reference tests' x^2 + y + 42 circuit, built on device."""
    from plonky2_tpu_torch.plonk.builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.witness import PartialWitness
    b = CircuitBuilder(config)
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_public_inputs([x, y, b.add(b.mul(x, x), b.add_const(y, 42))])
    pw = PartialWitness()
    pw.set_target(x, 3)
    pw.set_target(y, 5)
    return b.build(device), pw


def small_cyclic() -> dict:
    """The reference tests' iterated-hash IVC, two steps on cuda."""
    from plonky2_tpu_torch.hash.hashing import hash_no_pad_np
    from plonky2_tpu_torch.models.bench_recursion import recursion_config
    from plonky2_tpu_torch.plonk.builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.witness import PartialWitness
    from plonky2_tpu_torch.recursion import (add_virtual_proof_with_pis,
                                             set_proof_with_pis_target,
                                             set_verifier_data_target)
    from plonky2_tpu_torch.recursion.cyclic import (
        check_cyclic_proof_verifier_data, common_data_for_recursion,
        conditionally_verify_cyclic_proof_or_dummy, pad_to_common_degree)
    from plonky2_tpu_torch.recursion.dummy import (common_data_equal,
                                                   cyclic_base_proof)
    config = recursion_config(4, 8)
    common = common_data_for_recursion(config, num_extra_pis=9,
                                       min_degree_bits=13, device="cuda")
    b = CircuitBuilder(config)
    initial = b.add_virtual_targets(4)
    b.register_public_inputs(initial)
    current_in = b.add_virtual_targets(4)
    b.register_public_inputs(b.hash_n_to_hash_no_pad(list(current_in)))
    counter = b.add_virtual_target()
    b.register_public_input(counter)
    b.add_verifier_data_public_inputs()
    condition = b.add_virtual_target()
    inner_pt = add_virtual_proof_with_pis(b, common)
    for t0, t1 in zip(initial, inner_pt.public_inputs[0:4]):
        b.connect(t0, t1)
    for i in range(4):
        b.connect(current_in[i], b.select(
            condition, inner_pt.public_inputs[4 + i], initial[i]))
    b.connect(counter, b.add(inner_pt.public_inputs[8], condition))
    conditionally_verify_cyclic_proof_or_dummy(b, condition, inner_pt, common,
                                               "cuda")
    pad_to_common_degree(b, common)
    data = b.build("cuda")
    if not common_data_equal(data.common, common):
        fail("the cyclic circuit's shape diverged from its common data")
    h = np.array([1, 2, 3, 4], np.uint64)
    proof = cyclic_base_proof(
        common, data.verifier_only,
        {i: int(h[i % 4]) for i in range(8)} | {8: 0}, device="cuda")
    for step in (0, 1):
        pw = PartialWitness()
        pw.set_target(condition, step)
        set_proof_with_pis_target(pw, inner_pt, proof)
        set_verifier_data_target(pw, b.verifier_data_public_input,
                                 data.verifier_only)
        proof = data.prove(pw)
        check_cyclic_proof_verifier_data(proof, data.verifier_only, common)
        data.verify(proof)
        h = hash_no_pad_np(h)
        if [int(v) for v in proof.public_inputs[4:9]] != \
                [int(v) for v in h] + [step]:
            fail(f"cyclic step {step} has wrong public inputs")
    return {"degree": data.common.degree(), "steps": 2, "verified": True}


def small_stark_wrap() -> dict:
    """A 2^5-row Fibonacci STARK proof (8 queries) wrapped in a plonk
    circuit (4 queries), as the reference tests do."""
    from plonky2_tpu_torch.models.bench_recursion import recursion_config
    from plonky2_tpu_torch.plonk.builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.witness import PartialWitness
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.recursive_verifier import (
        add_virtual_stark_proof, set_stark_proof_target,
        verify_stark_proof_circuit)
    sconfig = small_stark_config()
    stark, trace, pis, _ = fib_inputs(5)
    stark_proof = prove(stark, sconfig, trace, pis, device="cuda")
    b = CircuitBuilder(recursion_config(4, 8))
    pt = add_virtual_stark_proof(b, stark, sconfig, 5)
    verify_stark_proof_circuit(b, stark, pt, sconfig, 5)
    b.register_public_inputs(pt.public_inputs)
    data = b.build("cuda")
    pw = PartialWitness()
    set_stark_proof_target(pw, pt, stark_proof)
    proof = data.prove(pw)
    data.verify(proof)
    if [int(v) for v in proof.public_inputs] != [int(v) for v in pis]:
        fail("the STARK wrapper does not expose the STARK's public inputs")
    return {"degree": data.common.degree(), "verified": True}


def small_stark_config():
    """The reference recursion tests' STARK config: rate 1, 8 queries."""
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.stark.config import StarkConfig
    return StarkConfig(fri_config=FriConfig(
        rate_bits=1, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
        num_query_rounds=8))


def small_staged() -> dict:
    """The three-table CTL demo: one wrapper circuit per table, seeded from
    the transcript's boundary states, and the root that ties them."""
    from plonky2_tpu_torch.models.bench_recursion import recursion_config
    from plonky2_tpu_torch.models.multi_table import ctl_demo
    from plonky2_tpu_torch.stark.multi import prove_multi_table
    from plonky2_tpu_torch.stark.staged import prove_staged
    sconfig = small_stark_config()
    starks, ctls, traces = ctl_demo()
    multi = prove_multi_table(starks, ctls, sconfig, traces, device="cuda")
    root, _ = prove_staged(starks, ctls, multi, sconfig,
                           recursion_config(4, 8), device="cuda")
    return {"tables": len(starks), "root_degree": root.data.common.degree(),
            "verified": True}


def small_aggregation() -> dict:
    """AllRecursiveCircuits over the two-table demo: built on cuda,
    checkpointed with to_bytes and restored with from_bytes(device="cuda"),
    then a root proof, its leaf + leaf aggregation and the first block
    (the deeper chain of tests/test_torch_aggregation.py was cut to keep
    the run inside its time)."""
    from plonky2_tpu_torch.models.bench_recursion import recursion_config
    from plonky2_tpu_torch.models.multi_table import aggregation_demo
    from plonky2_tpu_torch.stark.multi import prove_multi_table
    from plonky2_tpu_torch.zkevm.aggregation import AllRecursiveCircuits
    sconfig = small_stark_config()
    starks, ctls, traces = aggregation_demo()
    multi = prove_multi_table(starks, ctls, sconfig, traces, device="cuda")
    built = AllRecursiveCircuits(starks, ctls, sconfig, multi.degree_bits(),
                                 recursion_config(4, 8), device="cuda")
    blob = built.to_bytes()
    circuits = AllRecursiveCircuits.from_bytes(blob, starks, ctls, sconfig,
                                               device="cuda")
    if circuits.to_bytes() != blob:
        fail("the aggregation checkpoint does not re-encode to itself")
    root = circuits.prove_root(multi)
    agg1 = circuits.prove_aggregation(root, False, root, False)
    circuits.prove_block(None, agg1)
    return {"degree": circuits.block.common.degree(),
            "checkpoint_bytes": len(blob), "proofs": 3, "verified": True}


def small_checkpoint() -> dict:
    """The reference tests' checkpoint circuit: built on cuda, written,
    read back onto cuda, proved from the copy and verified by both."""
    from plonky2_tpu_torch.models.bench_recursion import recursion_config
    from plonky2_tpu_torch.plonk.builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.witness import PartialWitness
    from plonky2_tpu_torch.utils.serialization import (
        circuit_data_from_bytes, circuit_data_to_bytes)
    b = CircuitBuilder(recursion_config(4, 8))
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    out = b.add(b.mul(x, x), b.add_const(y, 42))
    bits = b.split_le(out, 32)
    picked = b.random_access(b.constant(3), bits[:4])
    ext = b.inverse_extension((x, y))
    lut = tuple((i, (i * i + 1) % 97) for i in range(16))
    lo = b.add_lookup_from_index(x, b.add_lookup_table_from_pairs(lut))
    b.register_public_inputs([x, y, out, picked, ext[0], lo])
    data = b.build("cuda")
    blob = circuit_data_to_bytes(data)
    copy = circuit_data_from_bytes(blob, device="cuda")
    if circuit_data_to_bytes(copy) != blob:
        fail("the circuit checkpoint does not re-encode to itself")
    pw = PartialWitness()
    pw.set_target(x, 3)
    pw.set_target(y, 5)
    proof = copy.prove(pw)
    data.verify(proof)
    copy.verify(proof)
    if int(proof.public_inputs[5]) != 10:
        fail("the checkpointed circuit's lookup output is wrong")
    return {"checkpoint_bytes": len(blob), "verified": True}


# The __global__ functions behind each C entry point, as the profiler names them.
KERNEL_FUNCTIONS = {"poseidon_permute": ("poseidon_kernel",),
                    "poseidon_hash_rows": ("hash_rows_kernel",
                                           "hash_rows_group_kernel"),
                    "poseidon_hash_cols": ("hash_cols_kernel",
                                           "hash_cols_group_kernel"),
                    "lde": ("lde_kernel",),
                    "ntt": ("dft_kernel",)}


def profile_prove(prove, kernels: list) -> dict:
    """One prove under torch.profiler: this process's device busy time
    (one stream, so its kernels do not overlap), its idle share of the wall
    time, and device time and launches of the ported kernels and the
    largest others."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    for k in kernels:
        k.reset()
    # device activity only: the host ops' events would multiply the trace
    # that the profiler parses and add nothing the lines below read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
    busy_ms = sum(us.values()) / 1e3
    ported = {}
    for k in kernels:
        names = [n for n in us if any(f in n for f in KERNEL_FUNCTIONS[k.symbol])]
        ported[k.symbol] = {"device_ms": sum(us[n] for n in names) / 1e3,
                            "profiled_launches": sum(count[n] for n in names),
                            "counted_launches": k.launches}
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_launches": sum(count.values()), "ported": ported,
            "top_kernels": [{"name": n[:90], "ms": t / 1e3, "count": count[n]}
                            for n, t in us.most_common(12)]}


def phase_profile(path: str, prove, kernels: list) -> dict:
    """One more prove under torch.profiler (profile_prove)."""
    prof = profile_prove(prove, kernels)
    if prof["device_busy_ms"] == 0:
        fail("the profiler recorded no device time")
    line("profile", path=path, **prof)
    return prof["ported"]


# The sharded phase's world: one rank per card over NCCL, up to four cards;
# on one card two ranks over gloo (NCCL refuses two ranks on one GPU), which
# still run the real 2-shard code on the card.
SHARDED_MAX_WORLD = 4
STREAM_SEEDS = ((0, 1), (2, 5), (3, 7))   # the pipelined stream's STARKs
STREAM_LOG_ROWS = 10
# C entries the sharded paths do not run: ShardedMerkleTree hashes each
# rank's block of leaf rows through the row entry (and the STARK's batches
# are not hashed at all, as in phase 11).
SHARDED_OFF_PATH = ("poseidon_hash_cols",)


def sharded_world() -> tuple:
    """(world size, backend, device of each rank)."""
    count = torch.cuda.device_count()
    if count >= 2:
        world = min(count, SHARDED_MAX_WORLD)
        return world, "nccl", [f"cuda:{r}" for r in range(world)]
    return 2, "gloo", ["cuda:0", "cuda:0"]


def sharded_rank(mesh, refs_path: str) -> dict:
    """The sharded phase on one rank: every check against the single-device
    result, each with its seconds; the warm sharded proves' kernel launches
    (counts set to 0 just before, read just after), collective bytes and
    seconds; the profiled STARK prove's device idle share."""
    import pickle
    from plonky2_tpu_torch.field import ntt
    from plonky2_tpu_torch.field.goldilocks import GF
    from plonky2_tpu_torch.field.ntt import LDE, NTT
    from plonky2_tpu_torch.hash.hashing import (HASH_COLS, HASH_ROWS,
                                                hash_or_noop)
    from plonky2_tpu_torch.hash.poseidon import POSEIDON
    from plonky2_tpu_torch.models.matrix_mul import matrix_mul_witness
    from plonky2_tpu_torch.models.multi_table import ctl_demo
    from plonky2_tpu_torch.parallel import mesh as M
    from plonky2_tpu_torch.parallel.distributed import all_processes_equal
    from plonky2_tpu_torch.parallel.groups import (device_groups,
                                                   pipeline_prove_stream)
    from plonky2_tpu_torch.parallel.multi_prover import \
        prove_multi_table_sharded
    from plonky2_tpu_torch.plonk.builder import CircuitBuilder
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.gates.base import GeneratorSpec
    from plonky2_tpu_torch.plonk.witness import PartialWitness
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.multi import prove_multi_table
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import verify_stark_proof
    from plonky2_tpu_torch.utils.serialization import (circuit_data_from_bytes,
                                                       proof_with_pis_to_bytes,
                                                       stark_proof_to_bytes)
    from plonky2_tpu_torch.zkevm.serialization import multi_proof_to_bytes

    with open(refs_path, "rb") as f:
        refs = pickle.load(f)
    kernels = [POSEIDON, HASH_ROWS, HASH_COLS, LDE, NTT]
    dev = mesh.device
    checks, seconds, out = {}, {}, {"rank": mesh.rank, "device": str(dev)}

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        return value

    def path_run(name, fn):
        """fn() once more with every kernel count and the collective bytes
        set to 0 just before it and read just after, and each ported
        kernel's device ms by CUDA events."""
        for k in kernels:
            k.reset()
        M.reset_bytes_moved()
        with KernelEvents(kernels) as events:
            value = timed(name, fn)
        out[name] = {"launches": {k.symbol: k.launches for k in kernels},
                     "collective_bytes": M.bytes_moved(),
                     "kernel_device_ms": events.kernel_ms()}
        return value

    # four_step_ntt at 2^20 points against the single-device ntt
    x = GF.from_u64(np.random.default_rng(20).integers(
        0, 2**64 - 2**32 + 1, size=1 << 20, dtype=np.uint64), dev)
    c = timed("four_step_ntt_2^20", lambda: M.four_step_ntt(x, mesh))
    got = GF(M.all_gather(c.v, mesh, axis=1).reshape(-1)).to_u64()
    checks["four_step_ntt_2^20"] = bool(np.array_equal(
        got, ntt.ntt(x).to_u64()))

    # dp_lde_and_leaf_hash at the plonk wires' (135, 2^15), rate 3
    polys = GF.from_u64(np.random.default_rng(21).integers(
        0, 2**64 - 2**32 + 1, size=(135, 1 << 15), dtype=np.uint64), dev)
    d = timed("dp_lde_and_leaf_hash", lambda: M.dp_lde_and_leaf_hash(
        M.shard_polys(polys, mesh), 3, 7, mesh, num_polys=135))
    got = GF(M.all_gather(d.v, mesh)).to_u64()
    want = hash_or_noop(GF(ntt.lde(polys, 3, shift=7).v.transpose(0, 1)
                           .contiguous())).to_u64()
    checks["dp_lde_and_leaf_hash"] = bool(np.array_equal(got, want))
    del x, polys, d, c, got, want

    # the 2^20-row STARK: cold, warm (counted), profiled
    config = StarkConfig.standard_fast_config()
    stark, trace, pis, _ = fib_inputs(20)

    def stark_prove():
        return prove(stark, config, trace, pis, mesh=mesh)
    cold = stark_proof_to_bytes(timed("stark_cold", stark_prove))
    stark_proof = path_run("sharded_stark_2^20", stark_prove)
    stark_bytes = stark_proof_to_bytes(stark_proof)
    checks["stark_bytes_equal_single_device"] = stark_bytes == refs["stark"]
    checks["stark_repeat_equal"] = cold == stark_bytes
    prof = profile_prove(stark_prove, kernels)
    out["stark_profile"] = {k: prof[k] for k in (
        "wall_ms_profiled", "device_busy_ms", "device_idle_share",
        "device_launches", "ported")}
    del trace

    # the m = 64 matmul plonk circuit at standard_recursion_config, read
    # from the checkpoint of phase 13's build (its witness seed included)
    blob, at, bt = refs["plonk_circuit"]
    data = timed("plonk_load", lambda: circuit_data_from_bytes(blob,
                                                              device=dev))
    del blob
    a, b = matmul_inputs(64, seed=10)
    pw = matrix_mul_witness(at, bt, a, b)
    cold = proof_with_pis_to_bytes(timed(
        "plonk_cold", lambda: data.prove(pw, mesh=mesh)))
    plonk_proof = path_run("sharded_plonk_m64",
                           lambda: data.prove(pw, mesh=mesh))
    plonk_bytes = proof_with_pis_to_bytes(plonk_proof)
    checks["plonk_bytes_equal_single_device"] = plonk_bytes == refs["plonk"]
    checks["plonk_repeat_equal"] = cold == plonk_bytes

    # a circuit without a witness seed whose gates hold a random nonce r
    # (a * b * r + r): its sharded proof verifies only if the ranks agree
    # on r
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    ta, tb, tr = builder.add_virtual_targets(3)
    builder.add_simple_generator(GeneratorSpec("random", deps=[], outs=[tr]))
    tc = builder.mul(ta, tb)
    builder.add(builder.mul(tc, tr), tr)
    builder.register_public_inputs([ta, tb, tc])
    nonce = builder.build(dev)
    npw = PartialWitness()
    npw.set_target(ta, 3)
    npw.set_target(tb, 5)
    nonce_proof = timed("plonk_unseeded", lambda: nonce.prove(npw, mesh=mesh))
    nonce.verify(nonce_proof)
    checks["plonk_unseeded_verified"] = True

    # models/multi_table.py: sharded, and through two device groups
    starks, ctls, traces = ctl_demo()
    multi = multi_proof_to_bytes(timed(
        "multi_table_sharded", lambda: prove_multi_table_sharded(
            starks, ctls, config, traces, mesh=mesh)))
    checks["multi_table_sharded_equal"] = multi == refs["multi"]
    groups = device_groups(2, mesh)
    grouped = multi_proof_to_bytes(timed(
        "multi_table_mesh_groups", lambda: prove_multi_table(
            starks, ctls, config, traces, mesh_groups=groups)))
    checks["multi_table_mesh_groups_equal"] = grouped == refs["multi"]

    # the pipelined stream over the two groups
    cases = [fib_inputs(STREAM_LOG_ROWS, a, b) for a, b in STREAM_SEEDS]
    stream = timed("pipeline_prove_stream", lambda: pipeline_prove_stream(
        cases[0][0], config, [c[1] for c in cases], [c[2] for c in cases],
        groups))
    stream = [stark_proof_to_bytes(p) for p in stream]
    checks["pipeline_stream_equal_sequential"] = stream == refs["stream"]

    everything = (stark_bytes + plonk_bytes + multi + grouped
                  + b"".join(stream))
    checks["all_processes_equal"] = all_processes_equal(everything, mesh)

    # host verifiers last, so that no rank waits in a collective meanwhile
    if mesh.rank == 0:
        timed("stark_verify", lambda: verify_stark_proof(stark, stark_proof,
                                                         config, 20))
        checks["stark_verified"] = True
    if mesh.rank == mesh.size - 1:
        timed("plonk_verify", lambda: data.verify(plonk_proof))
        checks["plonk_verified"] = True
    out.update(checks=checks, seconds=seconds,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    return out


def phase_sharded(stark_ref: dict, plonk_ref: dict) -> dict:
    """The sharded phase: the distributed prover (plonky2_tpu_torch.parallel)
    through spawn_world, every check held to the single-device result of
    this run; returns each kernel's launches on the sharded paths and their
    device ms per prove (summed over the ranks)."""
    import pickle
    import shutil
    import tempfile
    from plonky2_tpu_torch.models.multi_table import ctl_demo
    from plonky2_tpu_torch.parallel.distributed import spawn_world
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.multi import prove_multi_table
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.utils.serialization import stark_proof_to_bytes
    from plonky2_tpu_torch.zkevm.serialization import multi_proof_to_bytes

    config = StarkConfig.standard_fast_config()
    starks, ctls, traces = ctl_demo()
    cases = [fib_inputs(STREAM_LOG_ROWS, a, b) for a, b in STREAM_SEEDS]
    refs = {"stark": stark_ref["bytes"], "plonk": plonk_ref["bytes"],
            "plonk_circuit": plonk_ref["circuit"],
            "multi": multi_proof_to_bytes(prove_multi_table(
                starks, ctls, config, traces)),
            "stream": [stark_proof_to_bytes(prove(s, config, t, p))
                       for s, t, p, _ in cases]}
    world, backend, devices = sharded_world()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        refs_path = os.path.join(tmp, "refs.pkl")
        with open(refs_path, "wb") as f:
            pickle.dump(refs, f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(sharded_rank, world, backend,
                                lambda r: devices[r], args=(refs_path,),
                                timeout_s=600)
        except Exception as exc:
            fail(f"the sharded world failed: {exc}")
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in ranks:
        bad = [name for name, ok in r["checks"].items() if not ok]
        if bad:
            fail(f"sharded rank {r['rank']}: {bad} failed")
        for path in ("sharded_stark_2^20", "sharded_plonk_m64"):
            for sym, n in r[path]["launches"].items():
                if n == 0 and sym not in SHARDED_OFF_PATH:
                    fail(f"kernel {sym} was not launched on rank {r['rank']} "
                         f"of the {path} path")
    cards = len(set(devices))
    line("sharded", backend=backend, world_size=world, cards=cards,
         ranks_per_card=world // cards, devices=devices,
         world_seconds=world_s,
         collective_bytes_per_prove={
             path: [r[path]["collective_bytes"] for r in ranks]
             for path in ("sharded_stark_2^20", "sharded_plonk_m64")},
         warm_prove_seconds={
             "stark_2^20": {"sharded": [r["seconds"]["sharded_stark_2^20"]
                                        for r in ranks],
                            "single_device": stark_ref["warm_seconds"]},
             "plonk_m64": {"sharded": [r["seconds"]["sharded_plonk_m64"]
                                       for r in ranks],
                           "single_device": plonk_ref["warm_seconds"]}},
         stark_device_idle_share=[r["stark_profile"]["device_idle_share"]
                                  for r in ranks],
         stark_profile=[r["stark_profile"] for r in ranks],
         kernel_device_ms={
             path: [r[path]["kernel_device_ms"] for r in ranks]
             for path in ("sharded_stark_2^20", "sharded_plonk_m64")},
         seconds=[r["seconds"] for r in ranks],
         checks={k: v for r in ranks for k, v in r["checks"].items()},
         launches={path: [r[path]["launches"] for r in ranks]
                   for path in ("sharded_stark_2^20", "sharded_plonk_m64")},
         max_memory_allocated=[r["max_memory_allocated"] for r in ranks])
    launches = {path: {sym: sum(r[path]["launches"][sym] for r in ranks)
                       for sym in ranks[0][path]["launches"]}
                for path in ("sharded_stark_2^20", "sharded_plonk_m64")}
    device_ms = {path: {sym: sum(r[path]["kernel_device_ms"][sym]
                                 for r in ranks)
                        for sym in ranks[0][path]["kernel_device_ms"]}
                 for path in ("sharded_stark_2^20", "sharded_plonk_m64")}
    return {"launches": launches, "device_ms": device_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plonky2_tpu_torch.field.ntt import LDE, NTT
    from plonky2_tpu_torch.hash.hashing import HASH_COLS, HASH_ROWS
    from plonky2_tpu_torch.hash.poseidon import POSEIDON

    phase_card()
    phase_build()
    entries = [phase_poseidon(), *phase_hash_rows(), phase_lde(), phase_ntt()]
    phase_field()
    phase_small_proofs()
    phase_small_plonk()
    phase_small_multi()
    phase_small_plonk_extra()
    phase_small_recursion()
    kernels = [POSEIDON, HASH_ROWS, HASH_COLS, LDE, NTT]
    # the Fibonacci STARK commits batches of at most 4 polynomials, whose
    # leaves hash_or_noop keeps raw: only its FRI trees' leaves are hashed
    stark_kernels = [k for k in kernels if k is not HASH_COLS]
    stark_launches, stark_prove, stark_ref = phase_full_prove(
        kernels, required=stark_kernels)
    stark_profile = phase_profile("stark 2^20 rows", stark_prove, kernels)
    plonk_launches, plonk_prove, plonk_ref = phase_plonk(
        kernels, required=kernels)
    plonk_profile = phase_profile("plonk m=64", plonk_prove, kernels)
    wrap_launches, wrap_prove = phase_recursion(kernels, required=kernels)
    wrap_profile = phase_profile("recursion level 0", wrap_prove, kernels)
    zkevm_launches, zkevm_ms = phase_zkevm_transfer(kernels, required=kernels)
    sharded = phase_sharded(stark_ref, plonk_ref)
    for e, k in zip(entries, kernels):
        by_path = {"stark_2^20": stark_launches[k.symbol],
                   "plonk_m64": plonk_launches[k.symbol],
                   "zkevm_transfer": zkevm_launches[k.symbol],
                   "recursion_wrap": wrap_launches[k.symbol],
                   "sharded_stark_2^20":
                       sharded["launches"]["sharded_stark_2^20"][k.symbol],
                   "sharded_plonk_m64":
                       sharded["launches"]["sharded_plonk_m64"][k.symbol]}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        e["device_ms_per_prove"] = {
            "stark_2^20": stark_profile[k.symbol]["device_ms"],
            "plonk_m64": plonk_profile[k.symbol]["device_ms"],
            "zkevm_transfer": zkevm_ms[k.symbol],
            "recursion_wrap": wrap_profile[k.symbol]["device_ms"],
            "sharded_stark_2^20":
                sharded["device_ms"]["sharded_stark_2^20"][k.symbol],
            "sharded_plonk_m64":
                sharded["device_ms"]["sharded_plonk_m64"][k.symbol]}
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
