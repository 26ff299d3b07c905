"""Program ROM table: binds the bootstrapped memory image to public data.

The reference binds the kernel by keccak-hashing the bootstrapped bytes
and exposing the hash in PublicValues (cpu/bootstrap_kernel.rs:60).
The TPU-native design instead treats the whole bootstrap image —
kernel + user code, jumptables, shift table, jumpdest bits, global
metadata (kernel/aggregator.py Kernel.image) — as a *preprocessed*
table, like plonk's constants/sigmas commitment: its trace is a
deterministic function of public data, so the verifier recomputes the
table's trace commitment itself and pins the proof's cap against it
(generation.verify_program_proof).  A CTL per CPU memory channel ties
the bootstrap rows — which write the image into memory five entries per
row — to this table, so the executed machine state IS derived from the
public image:

    bootstrap write (seg, virt, word)  <-- CTL -->  ROM row (seg, virt, word)

Each side occurs exactly once per image entry (the image has distinct
addresses and fetches go through the memory table), so the
strict-multiset CTL applies directly.
"""

from __future__ import annotations

import numpy as np

from ..field import gl64
from ..stark.ctl import Column
from ..stark.stark import Stark
from .cpu import WORD_LIMBS

P = gl64.ORDER_INT


class ProgramStark(Stark):
    """Columns: FILTER | SEGMENT | VIRT | WORD (8 u32 limbs)."""

    PUBLIC_INPUTS = 0
    FILTER = 0
    SEGMENT = 1
    VIRT = 2
    WORD = range(3, 3 + WORD_LIMBS)
    COLUMNS = 3 + WORD_LIMBS

    def generate_trace(self, image: list, min_rows: int = 4) -> np.ndarray:
        """Deterministic from the public image: row i = (1, seg, virt,
        limbs(value)); zero padding."""
        n = 1 << max(max(len(image), min_rows) - 1, 0).bit_length()
        t = np.zeros((self.COLUMNS, n), np.uint64)
        for i, (seg, virt, w) in enumerate(image):
            t[self.FILTER, i] = 1
            t[self.SEGMENT, i] = seg
            t[self.VIRT, i] = virt
            for j in range(WORD_LIMBS):
                t[self.WORD.start + j, i] = (w >> (32 * j)) & 0xFFFFFFFF
        return t

    def eval_generic(self, ctx, vars, yield_constr) -> None:
        # shape constraints only — the verifier pins the whole trace by
        # recomputing its commitment (the CTL needs the filter binary
        # and in a prefix so padding cannot inject extra image entries)
        f = vars.local_values[self.FILTER]
        one = ctx.one()
        yield_constr.constraint(f * (f - one))
        nf = vars.next_values[self.FILTER]
        yield_constr.constraint_transition(nf * (one - f))

    def constraint_degree(self) -> int:
        return 3

    def ctl_data(self) -> list:
        return Column.singles([self.SEGMENT, self.VIRT] + list(self.WORD))

    def ctl_filter(self) -> Column:
        return Column.single(self.FILTER)
