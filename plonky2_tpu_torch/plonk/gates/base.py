"""Constraint-evaluation contexts (twin of reference gates/gate.rs:28).

AIR and gate code is written once against operator-overloaded field
elements plus a small ``ctx`` factory; the same code runs in the prover's
quotient pass (torch GF arrays over all coset points at once) and in the
verifier (host E2 extension scalars).
"""

from __future__ import annotations

from ...field import gl64ext
from ...field.goldilocks import GF


class BaseBatchCtx:
    """Prover context: elements are GF arrays broadcast over coset points."""

    ext = False

    def __init__(self, device):
        self.device = device

    def constant(self, v: int):
        return GF.full((), v, self.device)

    def zero(self):
        return GF.full((), 0, self.device)

    def one(self):
        return GF.full((), 1, self.device)


class ExtCtx:
    """Verifier context: elements are host E2 extension scalars."""

    ext = True

    def constant(self, v: int):
        return gl64ext.E2.from_base_int(v)

    def zero(self):
        return gl64ext.E2.of(0)

    def one(self):
        return gl64ext.E2.of(1)
