"""Peaks of one NVIDIA H100 SXM at its full 700 W power limit, frozen.

HBM3 bandwidth from NVIDIA's data sheet.  The integer peak is derived, not
published: 32-bit integer multiplies at 64 per clock per SM (the CUDA C++
Programming Guide's throughput table for compute capability 9.0) on 132
SMs at the top boost clock of 1.98 GHz.  A card that runs below that clock
reads a lower share; the run prints the SM clock beside the window.
"""

from __future__ import annotations

from prove_bench.reference import poseidon_constants as C

HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9

# A 64x64 -> 128-bit Goldilocks product is four 32x32 -> 64-bit partial
# products; the reduction needs none.  The bounds count only these
# multiplies, so they are floors.
MULMOD_MULS = 4


def poseidon_muls() -> int:
    """32-bit multiplies in one Poseidon permutation under the fast
    partial-round schedule (reference hash/poseidon.rs), the cheaper of the
    two schedules.  S-boxes: x^7 is four Goldilocks products, on 12 lanes
    in the 8 full rounds and on lane 0 in the 22 partial rounds.  A full
    round's MDS sums constant times 32-bit halves; a constant that is a
    power of two is a shift.  The partial rounds cost an 11 x 11 matrix of
    full constants once, then per round 22 full products and MDS[0][0]
    times lane 0 (two halves)."""
    def muls(consts):
        return sum(1 for c in consts if c & (c - 1))
    w = C.SPONGE_WIDTH
    sboxes = (C.N_FULL_ROUNDS_TOTAL * w + C.N_PARTIAL_ROUNDS) * 4 * MULMOD_MULS
    mds = 2 * (w * muls(C.MDS_MATRIX_CIRC) + muls(C.MDS_MATRIX_DIAG))
    partial = ((w - 1) ** 2 * MULMOD_MULS
               + C.N_PARTIAL_ROUNDS * (2 * (w - 1) * MULMOD_MULS + 2))
    return sboxes + C.N_FULL_ROUNDS_TOTAL * mds + partial
