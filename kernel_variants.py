#!/usr/bin/env python3
"""Time design variants of the port's CUDA kernels on one GPU.

Run from the repository root, with no arguments (both sources) or with
the sources whose variants to time:

    python3 kernel_variants.py [poseidon.cu] [ntt.cu]

Each variant is a text substitution in a committed source of
plonky2_tpu_torch/csrc (and, where the plan changes, in field/ntt.py's
mirror constants), built by nvcc into its own library under
plonky2_tpu_torch/_build/variants/ and bound in place of the committed
one.  For every variant the script prints one JSON line: the card, the
variant, and per main-path shape the kernel's median ms (CUDA events after
a warm-up) and whether its output equals the plain torch version.
Variants that skip work ("no_butterflies", "no_butterflies_no_twiddle")
only time the data movement that is left, and are not compared.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# goldilocks.cuh's add, sub and reduce128 with carries found by 64-bit
# compares and selects, in place of the PTX carry flag
COMPARE_SELECT = r'''
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  uint64_t s2 = s + (s < a ? EPS : 0);
  return s2 + (s2 < s ? EPS : 0);
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  uint64_t d2 = d - (a < b ? EPS : 0);
  return d2 - (d2 > d ? EPS : 0);
}

__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  uint64_t t1 = (hi_lo << 32) - hi_lo;
  uint64_t t2 = t0 + t1;
  return t2 + (t2 < t1 ? EPS : 0);
}

'''

RADIX_PASSES = '''    while (log_n - log_ns >= 3) { radix_pass<8, 3>(sh, p, log_ns, w); log_ns += 3; }
    if (log_n - log_ns == 2) radix_pass<4, 2>(sh, p, log_ns, w);
    else if (log_n - log_ns == 1) radix_pass<2, 1>(sh, p, log_ns, w);
'''


# poseidon.cu's lane-group partial rounds with the W_HATS dot product
# summed one round ahead: element 0 on every lane, so that no shuffle sits
# in the S-box's chain (D_{r+1} = E_r + s0 W_NEXT_DOT_V)
LANES_DOT_ONE_ROUND_AHEAD = r'''// sum_i W_HATS[r+1][i] VS[r][i] over the 11 columns, the same for every
// r < PARTIAL - 1 (hash/poseidon_constants.py; tests/test_torch_poseidon.py
// checks it).
constexpr uint64_t W_NEXT_DOT_V = 5017;

// (k a + b) mod p for a small constant k (k 2^32 + 2^32 < 2^43): products of
// the 32-bit halves, one reduce_halves.
__device__ __forceinline__ uint64_t small_mul_add(uint64_t a, uint64_t k,
                                                  uint64_t b) {
  return gl::reduce_halves(k * (uint32_t)a + (uint32_t)b,
                           k * (uint32_t)(a >> 32) + (b >> 32));
}

// The sum over the group's lanes, on every lane: a 4-step xor butterfly.
__device__ __forceinline__ uint64_t group_sum(uint64_t v) {
#pragma unroll
  for (int m = 1; m < GROUP; m <<= 1) v = gl::add(v, from_lane_xor(v, m));
  return v;
}

// The fast partial rounds (partial_rounds' schedule) on a group.  Every
// lane holds state element 0 (x0, the same on all lanes) and lane l in
// 1..11 element l (xi); lm is the lane's column of the (WIDTH - 1)-wide
// tables (lanes 0 and 12-15 read a column whose value they discard).
// Round r: s0 = sbox(x0) + RC; x0' = 25 s0 + D_r; xi' = xi + s0 VS[r][lm],
// with D_r = sum_i s[i] W_HATS[r][i-1].  D_{r+1} = E_r + s0 W_NEXT_DOT_V,
// where E_r = sum_i s[i] W_HATS[r+1][i-1] over the state before the update:
// E_r's products and group sum run beside the S-box, and a round's chain is
// the S-box and one small-constant multiply-add, with no shuffle in it.
__device__ __forceinline__ uint64_t partial_rounds_lanes(uint64_t x, int l,
                                                         int lm,
                                                         const LaneConsts& c) {
  const bool dot_lane = l >= 1 && l < WIDTH;
  x = gl::add(x, c.first_rc[l < WIDTH ? l : 0]);
  // mds_partial_layer_init: element 0 passes, lane c takes
  // sum_r s[r] INIT[r-1][c-1]
  Acc acc;
#pragma unroll
  for (int r = 1; r < WIDTH; r++)
    acc.add_product(from_lane(x, r), c.init[(r - 1) * (WIDTH - 1) + lm]);
  uint64_t xi = acc.reduce();
  uint64_t x0 = from_lane(x, 0);
  uint64_t d = group_sum(dot_lane ? gl::mul(xi, c.w_hats[lm]) : 0);
#pragma unroll 1
  for (int r = 0; r < PARTIAL; r++) {
    const uint64_t s0 = gl::add(sbox(x0), PARTIAL_RC[r]);
    uint64_t e = 0;
    if (r + 1 < PARTIAL)
      e = group_sum(dot_lane ? gl::mul(xi, c.w_hats[(r + 1) * (WIDTH - 1) + lm])
                             : 0);
    x0 = small_mul_add(s0, MDS00, d);
    xi = gl::mul_add(s0, c.vs[r * (WIDTH - 1) + lm], xi);
    d = gl::mul_add(s0, W_NEXT_DOT_V, e);
  }
  return l == 0 ? x0 : xi;
}

'''


def lanes_dot_one_round_ahead(src: str) -> str:
    start = src.index("// The fast partial rounds on a group (partial_rounds' schedule).")
    end = src.index("__device__ __forceinline__ uint64_t permute_lanes(")
    return src[:start] + LANES_DOT_ONE_ROUND_AHEAD + src[end:]


def compare_select(gl: str) -> str:
    start = gl.index("// Carries and borrows")
    end = gl.index("// The full 128-bit product")
    return gl[:start] + COMPARE_SELECT + gl[end:]


def sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"variant text not found: {old[:60]!r}")
    return text.replace(old, new)


# name -> (edit of the source, edit of goldilocks.cuh or None); the NTT's
# also carry field/ntt.py's constants for the plan and whether the output
# is compared with the plain version
POSEIDON_VARIANTS = {
    "committed": (lambda s: s, None),
    "compare_select": (lambda s: s, compare_select),
    "no_register_cap": (lambda s: sub(s, "constexpr int MIN_BLOCKS = 8;",
                                   "constexpr int MIN_BLOCKS = 1;"), None),
    "partial_rounds_unrolled": (lambda s: sub(
        s, "#pragma unroll 1\n  for (int r = 0; r < PARTIAL",
        "#pragma unroll\n  for (int r = 0; r < PARTIAL"), None),
    "sponge_min_blocks_8": (lambda s: sub(s, "constexpr int SPONGE_MIN_BLOCKS = 6;",
                                          "constexpr int SPONGE_MIN_BLOCKS = 8;"),
                            None),
    "sponge_min_blocks_4": (lambda s: sub(s, "constexpr int SPONGE_MIN_BLOCKS = 6;",
                                          "constexpr int SPONGE_MIN_BLOCKS = 4;"),
                            None),
    "lanes_dot_one_round_ahead": (lanes_dot_one_round_ahead, None),
}
NTT_VARIANTS = {
    "committed": (lambda s: s, None, {}, True),
    "compare_select": (lambda s: s, compare_select, {}, True),
    "three_passes_above_2^18": (lambda s: sub(s, "MAX_TWO_PASS = 22;",
                                              "MAX_TWO_PASS = 18;"),
                                None, {"MAX_TWO_PASS": 18}, True),
    "tile_2^12": (lambda s: sub(s, "LOG_TILE = 13;", "LOG_TILE = 12;"),
                  None, {"LOG_TILE": 12}, True),
    "64_columns": (lambda s: sub(s, "MAX_C = 16;", "MAX_C = 64;"), None, {},
                   True),
    "no_butterflies": (lambda s: sub(s, RADIX_PASSES, ""), None, {}, False),
    "no_butterflies_no_twiddle": (lambda s: sub(sub(s, RADIX_PASSES, ""),
                                                "if (p.twiddle) {",
                                                "if (false) {"),
                                  None, {}, False),
}


def build(variants: dict, source: str, out_dir: str) -> dict:
    """nvcc every variant in parallel; {name: library path}."""
    from plonky2_tpu_torch.utils import cuda
    src = (cuda.CSRC / source).read_text()
    gl = (cuda.CSRC / "goldilocks.cuh").read_text()
    procs = {}
    for name, spec in variants.items():
        vdir = os.path.join(out_dir, f"{source}.{name}")
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, source), "w") as f:
            f.write(spec[0](src))
        with open(os.path.join(vdir, "goldilocks.cuh"), "w") as f:
            f.write(spec[1](gl) if spec[1] else gl)
        lib = os.path.join(vdir, "kernel.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", lib,
             os.path.join(vdir, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {name}:\n{log}")
        libs[name] = lib
        print(json.dumps({"build": f"{source} {name}", "ptxas": [
            ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]}),
            flush=True)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plonky2_tpu_torch.field.goldilocks import canonical
    from plonky2_tpu_torch.utils import cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out_dir = str(cuda.BUILD_ROOT / "variants")
    rng = np.random.default_rng(1)

    def rand(shape):
        return torch.from_numpy(rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
                                .view(np.int64)).cuda()

    def same(a, b) -> bool:
        return bool(torch.equal(canonical(a), canonical(b)))

    def bind(source: str, lib: str, kernels: list) -> None:
        cuda._libs[source] = ctypes.CDLL(lib)
        for k in kernels:
            k._fn = None

    sources = sys.argv[1:] or ["poseidon.cu", "ntt.cu"]
    if "poseidon.cu" in sources:
        time_poseidon_variants(card, out_dir, rand, same, bind)
    if "ntt.cu" in sources:
        time_ntt_variants(card, out_dir, rand, same, bind)
    return 0


def time_poseidon_variants(card, out_dir, rand, same, bind) -> None:
    import chip_smoke as cs
    from plonky2_tpu_torch.hash import hashing, poseidon
    states17, states20 = rand((1 << 17, 12)), rand((1 << 20, 12))
    rows = rand((1 << 18, 135))
    cols = rows.transpose(0, 1).contiguous()
    keccak = rand((1 << 10, 2481))
    keccak_cols = keccak.transpose(0, 1).contiguous()
    want17 = poseidon.permute_torch(states17)
    want_rows = hashing.hash_no_pad_torch(rows)
    want_cols = hashing.hash_cols_torch(cols)
    want_keccak = hashing.hash_no_pad_torch(keccak)
    cases = {
        "sponge rows (2^18, 135)": (lambda: hashing.hash_rows_cuda(rows), want_rows),
        "sponge cols (2^18, 135)": (lambda: hashing.hash_cols_cuda(cols), want_cols),
        "sponge cols (2^10, 2481), 16 lanes": (
            lambda: hashing.hash_cols_cuda(keccak_cols, leaf_order=False,
                                           group=hashing.SPONGE_GROUP),
            want_keccak),
        "sponge rows (1, 2481), 16 lanes": (
            lambda: hashing.hash_rows_cuda(keccak[:1], group=hashing.SPONGE_GROUP),
            want_keccak[:1])}
    for name, lib in build(POSEIDON_VARIANTS, "poseidon.cu", out_dir).items():
        bind("poseidon.cu", lib, [poseidon.POSEIDON, hashing.HASH_ROWS,
                                  hashing.HASH_COLS])
        res = {"permute 2^17": [cs.cuda_ms(lambda: poseidon.permute_cuda(states17), 20),
                                same(poseidon.permute_cuda(states17), want17)],
               "permute 2^20": [cs.cuda_ms(lambda: poseidon.permute_cuda(states20), 10),
                                None]}
        for case, (fn, want) in cases.items():
            res[case] = [cs.cuda_ms(fn, 5), same(fn(), want)]
        print(json.dumps({"card": card, "source": "poseidon.cu", "variant": name,
                          "ms_and_exact": res}), flush=True)


def time_ntt_variants(card, out_dir, rand, same, bind) -> None:
    import chip_smoke as cs
    from plonky2_tpu_torch.field import ntt
    from plonky2_tpu_torch.field.goldilocks import GF

    cases = {"lde (135, 2^15, r=3)": (lambda x: ntt.lde_cuda(x, 3, 7),
                                      lambda x: ntt.lde_torch(x, 3, 7), (135, 15)),
             "lde (4, 2^20, r=1)": (lambda x: ntt.lde_cuda(x, 1, 7),
                                    lambda x: ntt.lde_torch(x, 1, 7), (4, 20)),
             "intt (135, 2^15)": (ntt.intt, ntt.intt_torch, (135, 15)),
             "coset_intt (2, 2^18)": (lambda x: ntt.coset_intt(x, 7),
                                      lambda x: ntt.coset_intt_torch(x, 7), (2, 18)),
             "coset_ntt (2, 2^20)": (lambda x: ntt.coset_ntt(x, 7),
                                     lambda x: ntt.coset_ntt_torch(x, 7), (2, 20))}
    inputs = {c: GF(rand((k, 1 << log_n))) for c, (_, _, (k, log_n)) in cases.items()}
    wants = {c: plain(inputs[c]) for c, (_, plain, _) in cases.items()}
    committed = {"LOG_TILE": ntt.LOG_TILE, "MAX_TWO_PASS": ntt.MAX_TWO_PASS}
    for name, lib in build(NTT_VARIANTS, "ntt.cu", out_dir).items():
        _, _, consts, compared = NTT_VARIANTS[name]
        bind("ntt.cu", lib, [ntt.NTT, ntt.LDE])
        for key, value in {**committed, **consts}.items():
            setattr(ntt, key, value)
        ntt._kernel_tables.cache_clear()
        res = {}
        for c, (kernel, _, _) in cases.items():
            x = inputs[c]
            ms = cs.cuda_ms(lambda: kernel(x), 10)
            res[c] = [ms, same(kernel(x).v, wants[c].v) if compared else None]
        print(json.dumps({"card": card, "source": "ntt.cu", "variant": name,
                          "ms_and_exact": res}), flush=True)
    for key, value in committed.items():
        setattr(ntt, key, value)


if __name__ == "__main__":
    sys.exit(main())
