"""Work a STARK proof needs, from the statement's parameters: the
Poseidon permutations of its Merkle trees, and the bytes of the (i)NTTs
and LDEs of its polynomials.  Both are floors: they count what the proof
system needs (reference starky src/prover.rs, plonky2 fri/prover.rs), not
what an implementation happens to do.

Trees: a leaf of more than 4 elements is hashed, ceil(len / 8)
permutations; shorter leaves are their own digest.  A tree of L leaves
under a cap of 2^h digests compresses L - 2^h inner nodes, one
permutation each.  The initial trees hold the trace, the permutation Z
columns and the quotient chunks on the LDE of N = rows << rate_bits
points; FRI's round i commits N_i / arity cosets of 2 * arity elements,
N_0 = N, N_{i+1} = N_i / arity.

Transforms, 8 bytes an element, each input read once and each output
written once: the trace and Z columns from values to coefficients (an
iNTT of n) and out to the LDE (n coefficients in, N values out); the
quotient from its values on the quotient coset to coefficients (a coset
iNTT of n << quotient_degree_bits), its chunks out to the LDE; the FRI
polynomial's LDE (2 components); and each fold but the last out to the
next codeword (n_{i+1} nonzero coefficients in, N_{i+1} values out, 2
components).
"""

from __future__ import annotations

from prove_bench.reference.fri import FriParams


def _tree_perms(leaves: int, leaf_len: int, cap_height: int) -> int:
    hashed = leaves * -(-leaf_len // 8) if leaf_len > 4 else 0
    return hashed + max(leaves - (1 << cap_height), 0)


def shape(rows: int, columns: int, perm_zs: int, num_challenges: int,
          constraint_degree: int, fri: dict) -> dict:
    degree_bits = rows.bit_length() - 1
    params = FriParams.from_config(fri, degree_bits)
    qdf = max(1, constraint_degree - 1)
    return {"n": rows, "N": rows << params.rate_bits, "columns": columns,
            "perm_zs": perm_zs, "quotient": num_challenges * qdf,
            "quotient_bits": (qdf - 1).bit_length(), "nc": num_challenges,
            "rate_bits": params.rate_bits, "cap_height": params.cap_height,
            "arities": params.reduction_arity_bits}


def permutations(s: dict) -> int:
    """Permutations of one proof's trees; the grind's are per proof
    (grind_permutations)."""
    total = sum(_tree_perms(s["N"], k, s["cap_height"])
                for k in (s["columns"], s["perm_zs"], s["quotient"]) if k)
    size = s["N"]
    for a in s["arities"]:
        arity = 1 << a
        total += _tree_perms(size // arity, 2 * arity, s["cap_height"])
        size //= arity
    return total


def grind_permutations(pow_witness: int) -> int:
    """The grind tries candidates 0, 1, ... up to the witness it found."""
    return int(pow_witness) + 1


def ntt_bytes(s: dict) -> int:
    n, big = s["n"], s["N"]

    def lde(polys):
        return polys * (n + big)

    elems = 0
    for polys in (s["columns"], s["perm_zs"]):
        if polys:
            elems += 2 * polys * n + lde(polys)
    elems += 2 * s["nc"] * (n << s["quotient_bits"]) + lde(s["quotient"])
    elems += lde(2)
    size = big
    for a in s["arities"][:-1]:
        size >>= a
        elems += 2 * ((size >> s["rate_bits"]) + size)
    return 8 * elems
