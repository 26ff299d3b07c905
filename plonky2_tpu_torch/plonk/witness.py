"""Witness generation: build-time leveled dataflow, batched numpy execution.

The reference runs a dynamic watch-list scheduler over boxed generators
(iop/generator.rs:19-99).  Its firing order is data-independent for every
deterministic circuit, so we topologically level the generator dataflow
*once at build time* (through the copy-constraint equivalence classes), then
execute each level as a handful of vectorised numpy dispatches grouped by
generator kind — e.g. all ArithmeticGate ops in a level run as one gather /
mul / scatter, every PoseidonGate in a level hashes as one (B, 12) batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import gl64
from .gates.base import GeneratorSpec
from .gates.poseidon_gate import poseidon_generator_trace
from . import targets as tg


class PartialWitness:
    """User-provided inputs (reference iop/witness.rs:267)."""

    def __init__(self):
        self.entries: dict[int, int] = {}

    def set_target(self, t: int, value: int) -> None:
        self.entries[t] = int(value) % gl64.ORDER_INT

    def set_wire(self, row: int, column: int, value: int) -> None:
        self.set_target(tg.wire(row, column), value)


@dataclass
class _Group:
    kind: str
    dep_reps: np.ndarray  # (g, d) int64
    out_reps: np.ndarray  # (g, o) int64
    params: np.ndarray | list  # kind-specific
    fns: list | None = None
    names: list | None = None  # registry names (kind == "custom" only)


class WitnessSchedule:
    """Dense representative map + leveled, kind-grouped generator plan."""

    def __init__(self, num_rows: int, num_wires: int, num_virtual: int,
                 copy_pairs: list, generators: list[GeneratorSpec],
                 rng_seed: int | None = None):
        # rng_seed None -> fresh OS entropy per generate() (the reference's
        # RandomValueGenerator uses OsRng); pass a seed for reproducibility
        self.num_rows = num_rows
        self.num_wires = num_wires
        self.num_virtual = num_virtual
        self.total = num_rows * num_wires + num_virtual
        self.rng_seed = rng_seed

        # --- union-find over dense target indices ---
        parents = np.arange(self.total, dtype=np.int64)

        def dense(t: int) -> int:
            if tg.is_wire(t):
                return tg.wire_row(t) * num_wires + tg.wire_column(t)
            return num_rows * num_wires + tg.virtual_index(t)

        self._dense = dense

        def find(i: int) -> int:
            while parents[i] != i:
                parents[i] = parents[parents[i]]
                i = parents[i]
            return int(i)

        for a, b in copy_pairs:
            ra, rb = find(dense(a)), find(dense(b))
            if ra != rb:
                parents[rb] = ra
        # full path compression by pointer doubling
        while True:
            nxt = parents[parents]
            if np.array_equal(nxt, parents):
                break
            parents = nxt
        self.parents = parents

        # --- level the generators ---
        # A rep (copy-constraint class) may have SEVERAL producers: e.g. a
        # gate output wire connected to a constant target, or two gadgets
        # whose outputs are connect()ed.  All producers write the same value
        # (the witness satisfies the circuit by construction), so a rep
        # becomes *available* when its FIRST producer fires — OR-semantics.
        # Keeping only one producer would manufacture false dependency
        # cycles (the reference's dynamic watch-list, iop/generator.rs:54,
        # never has this problem; this is its static equivalent).
        gen_deps = []
        gen_outs = []
        producers_of: dict[int, list] = {}
        for gi, g in enumerate(generators):
            dreps = [int(parents[dense(t)]) for t in g.deps]
            oreps = [int(parents[dense(t)]) for t in g.outs]
            gen_deps.append(dreps)
            gen_outs.append(oreps)
            for r in oreps:
                producers_of.setdefault(r, []).append(gi)

        rep_level: dict[int, int] = {}
        consumers_of_rep: dict[int, list] = {}
        remaining: list[set] = []
        for gi, dreps in enumerate(gen_deps):
            waiting = {r for r in dreps
                       if r in producers_of and gi not in producers_of[r]}
            # deps produced by *other* gens must wait; producer-less deps
            # (public inputs, never-written wires) are available at level 0
            remaining.append(waiting)
            for r in waiting:
                consumers_of_rep.setdefault(r, []).append(gi)
            for r in dreps:
                if r not in producers_of:
                    rep_level[r] = 0

        from collections import deque
        level = [0] * len(generators)
        queue = deque(gi for gi, w in enumerate(remaining) if not w)
        processed_set = set()
        while queue:
            gi = queue.popleft()
            if gi in processed_set:
                continue
            processed_set.add(gi)
            lv = 0
            for r in gen_deps[gi]:
                lv = max(lv, rep_level.get(r, 0) + 1)
            level[gi] = lv
            for r in gen_outs[gi]:
                if r not in rep_level:
                    rep_level[r] = lv
                    for c in consumers_of_rep.get(r, ()):
                        remaining[c].discard(r)
                        if not remaining[c] and c not in processed_set:
                            queue.append(c)
        # Generators stuck in genuine dependency cycles fall back to a small
        # dynamic pass at generate() time.
        self.residual = [gi for gi in range(len(generators))
                         if gi not in processed_set]
        self._residual_specs = [(generators[gi], gen_deps[gi], gen_outs[gi])
                                for gi in self.residual]
        leveled_outs = {r for gi in processed_set for r in gen_outs[gi]}
        residual_outs = {r for gi in self.residual for r in gen_outs[gi]}
        self._residual_out_reps = residual_outs - leveled_outs

        # --- group by (level, kind, arity, static params) ---
        residual_set = set(self.residual)
        by_level_kind: dict[tuple, list] = {}
        for gi, g in enumerate(generators):
            if gi in residual_set:
                continue
            if g.kind in ("arithmetic", "constant", "random", "copy", "custom",
                          "arith_ext", "mul_ext"):
                pkey = ()  # per-instance params are batched as arrays
            else:
                pkey = g.params  # must be uniform within a batch
            key = (level[gi], g.kind, len(g.deps), len(g.outs), pkey)
            by_level_kind.setdefault(key, []).append(gi)

        # one global sort, then bucket groups by level (a per-level rescan
        # of the whole dict is quadratic on recursion-sized circuits)
        groups_by_level: dict[int, list] = {}
        for key in sorted(by_level_kind.keys(),
                          key=lambda k: (k[0], str(k[1:]))):
            gis = by_level_kind[key]
            glv, kind = key[0], key[1]
            dep_mat = np.array([gen_deps[gi] for gi in gis], dtype=np.int64) \
                if gen_deps[gis[0]] else np.zeros((len(gis), 0), np.int64)
            out_mat = np.array([gen_outs[gi] for gi in gis], dtype=np.int64)
            if kind in ("arithmetic", "arith_ext", "mul_ext"):
                params = np.array([generators[gi].params for gi in gis],
                                  dtype=np.uint64)
            elif kind == "constant":
                params = np.array([generators[gi].params[0] for gi in gis],
                                  dtype=np.uint64)
            else:
                params = [generators[gi].params for gi in gis]
            fns = [generators[gi].fn for gi in gis] if kind == "custom" else None
            names = ([generators[gi].name for gi in gis]
                     if kind == "custom" else None)
            groups_by_level.setdefault(glv, []).append(
                _Group(kind, dep_mat, out_mat, params, fns, names))
        self.levels: list[list[_Group]] = [
            groups_by_level[lv] for lv in sorted(groups_by_level)]

    # ------------------------------------------------------------------
    def generate(self, pw: PartialWitness,
                 rng_seed: int | None = None) -> np.ndarray:
        """Run all generators; returns the (num_wires, num_rows) wire matrix.
        rng_seed, when given, replaces the schedule's own seed."""
        values = np.zeros(self.total, dtype=np.uint64)
        parents = self.parents
        for t, v in pw.entries.items():
            values[parents[self._dense(t)]] = np.uint64(v)

        rng = np.random.default_rng(
            self.rng_seed if rng_seed is None else rng_seed)
        for groups in self.levels:
            for g in groups:
                self._exec_group(g, values, rng)

        # dynamic pass for generators in copy-constraint cycles
        if self._residual_specs:
            set_mask = np.ones(self.total, dtype=bool)
            for r in self._residual_out_reps:
                set_mask[r] = False
            for t in pw.entries:
                set_mask[parents[self._dense(t)]] = True
            pending = list(self._residual_specs)
            while pending:
                progressed = False
                still = []
                for spec, dreps, oreps in pending:
                    if all(set_mask[r] for r in dreps):
                        grp = _Group(
                            spec.kind,
                            np.array([dreps], dtype=np.int64)
                            if dreps else np.zeros((1, 0), np.int64),
                            np.array([oreps], dtype=np.int64),
                            np.array([spec.params], dtype=np.uint64)
                            if spec.kind in ("arithmetic", "arith_ext", "mul_ext")
                            else (np.array([spec.params[0]], dtype=np.uint64)
                                  if spec.kind == "constant" else [spec.params]),
                            [spec.fn] if spec.kind == "custom" else None)
                        self._exec_group(grp, values, rng)
                        for r in oreps:
                            set_mask[r] = True
                        progressed = True
                    else:
                        still.append((spec, dreps, oreps))
                pending = still
                if not progressed and pending:
                    raise ValueError(
                        f"{len(pending)} generators never became runnable "
                        "(unsatisfiable dependency cycle)")

        wires = values[parents[: self.num_rows * self.num_wires]]
        return wires.reshape(self.num_rows, self.num_wires).T.copy(), values

    def _exec_group(self, g: _Group, values: np.ndarray, rng) -> None:
        if g.kind == "arithmetic":
            deps = values[g.dep_reps]  # (g, 3)
            c0 = g.params[:, 0]
            c1 = g.params[:, 1]
            out = gl64.add(gl64.mul(c0, gl64.mul(deps[:, 0], deps[:, 1])),
                           gl64.mul(c1, deps[:, 2]))
            values[g.out_reps[:, 0]] = out
        elif g.kind == "poseidon":
            deps = values[g.dep_reps]  # (g, 13)
            trace = poseidon_generator_trace(deps)
            values[g.out_reps] = gl64.to_canonical(trace)
        elif g.kind == "constant":
            values[g.out_reps[:, 0]] = g.params
        elif g.kind == "random":
            values[g.out_reps[:, 0]] = rng.integers(
                0, gl64.ORDER_INT, size=len(g.out_reps), dtype=np.uint64)
        elif g.kind == "copy":
            values[g.out_reps[:, 0]] = values[g.dep_reps[:, 0]]
        elif g.kind == "arith_ext":
            from ..field import gl64ext
            deps = values[g.dep_reps]  # (g, 6): m0(2) m1(2) ad(2)
            params = np.asarray(g.params, dtype=np.uint64)
            m0 = deps[:, 0:2]
            m1 = deps[:, 2:4]
            ad = deps[:, 4:6]
            out = gl64ext.add(
                gl64ext.scalar_mul(gl64ext.mul(m0, m1), params[:, 0]),
                gl64ext.scalar_mul(ad, params[:, 1]))
            values[g.out_reps] = gl64.to_canonical(out)
        elif g.kind == "mul_ext":
            from ..field import gl64ext
            deps = values[g.dep_reps]  # (g, 4)
            params = np.asarray(g.params, dtype=np.uint64)
            out = gl64ext.scalar_mul(
                gl64ext.mul(deps[:, 0:2], deps[:, 2:4]), params[:, 0])
            values[g.out_reps] = gl64.to_canonical(out)
        elif g.kind == "reducing":
            from ..field import gl64ext
            num_coeffs, is_ext = g.params[0]
            deps = values[g.dep_reps]
            alpha = deps[:, 0:2]
            acc = deps[:, 2:4]
            outs = np.empty((len(deps), num_coeffs, 2), dtype=np.uint64)
            for i in range(num_coeffs):
                if is_ext:
                    coeff = deps[:, 4 + 2 * i: 6 + 2 * i]
                else:
                    coeff = gl64ext.from_base(deps[:, 4 + i])
                acc = gl64ext.add(gl64ext.mul(acc, alpha), coeff)
                outs[:, i] = acc
            values[g.out_reps] = gl64.to_canonical(
                outs.reshape(len(deps), -1))
        elif g.kind == "poseidon_mds":
            from ..field import gl64ext
            from ..hash import poseidon_constants as PC
            deps = values[g.dep_reps].reshape(-1, 12, 2)
            outs = np.zeros_like(deps)
            for r in range(12):
                acc = gl64ext.ZERO
                for i in range(12):
                    acc = gl64ext.add(acc, gl64ext.scalar_mul(
                        deps[:, (i + r) % 12],
                        np.uint64(PC.MDS_MATRIX_CIRC[i])))
                if PC.MDS_MATRIX_DIAG[r]:
                    acc = gl64ext.add(acc, gl64ext.scalar_mul(
                        deps[:, r], np.uint64(PC.MDS_MATRIX_DIAG[r])))
                outs[:, r] = acc
            values[g.out_reps] = gl64.to_canonical(outs.reshape(len(deps), -1))
        elif g.kind == "base_sum":
            base, num_limbs = g.params[0]
            s = gl64.to_canonical(values[g.dep_reps[:, 0]]).astype(object)
            limbs = np.empty((len(s), num_limbs), dtype=np.uint64)
            for i in range(num_limbs):
                limbs[:, i] = (s % base).astype(np.uint64)
                s //= base
            values[g.out_reps] = limbs
        elif g.kind == "exponentiation":
            (nbits,) = g.params[0]
            deps = values[g.dep_reps]  # (g, 1 + nbits)
            base = deps[:, 0]
            bits = deps[:, 1:]
            iv = np.ones(len(deps), dtype=np.uint64)
            outs = np.empty((len(deps), nbits + 1), dtype=np.uint64)
            for i in range(nbits):
                prev = iv if i == 0 else gl64.square(iv)
                cur_bit = bits[:, nbits - i - 1]
                mult = np.where(gl64.to_canonical(cur_bit) != 0, base,
                                np.uint64(1))
                iv = gl64.mul(prev, mult)
                outs[:, i] = iv
            outs[:, nbits] = iv
            values[g.out_reps] = gl64.to_canonical(outs)
        elif g.kind == "random_access_bits":
            (nbits,) = g.params[0]
            idx = gl64.to_canonical(values[g.dep_reps[:, 0]])
            bits = ((idx[:, None] >> np.arange(nbits, dtype=np.uint64))
                    & np.uint64(1))
            values[g.out_reps] = bits.astype(np.uint64)
        elif g.kind == "custom":
            for i, fn in enumerate(g.fns):
                outs = fn(values[g.dep_reps[i]])
                values[g.out_reps[i]] = np.asarray(outs, dtype=np.uint64)
        else:
            raise ValueError(f"unknown generator kind {g.kind}")

    def values_of(self, values: np.ndarray, ts: list) -> np.ndarray:
        idx = np.array([self.parents[self._dense(t)] for t in ts], dtype=np.int64)
        return values[idx] if len(idx) else np.zeros(0, dtype=np.uint64)

    def rep(self, t: int) -> int:
        return int(self.parents[self._dense(t)])
