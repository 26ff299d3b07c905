"""CosetInterpolationGate: barycentric interpolation over a coset of the
two-adic subgroup, with a configurable constraint-degree bound.

Twin of reference gates/coset_interpolation.rs:49-536.  Given values v[] of a
polynomial on the coset shift*H (|H| = 2^subgroup_bits), an evaluation point
z, and the fixed barycentric weights w[] of H, the gate checks the running
recurrences (numerator-form barycentric interpolation; no divisions):

    p[0] = 1                  p[i] = p[i-1] * (zs - x[i-1])
    e[0] = 0                  e[i] = e[i-1] * (zs - x[i-1]) + w[i-1]*v[i-1]*p[i-1]

where zs = z * shift^{-1} maps interpolation on the coset back to H (the
weights of H are then circuit constants).  e[N] = P(z).  Every (degree-1)
steps the running (e, p) pair is pinned to intermediate wires to bound the
constraint degree.
"""

from __future__ import annotations

import numpy as np

from ...field import gl64, gl64ext
from .. import targets
from .base import EvalVars, Gate, GeneratorSpec
from .ext_gates import D, ExtAlg


def _subgroup(subgroup_bits: int) -> list:
    return [int(x) for x in gl64.two_adic_subgroup(subgroup_bits)]


def _barycentric_weights(subgroup_bits: int) -> list:
    """w_i = 1 / prod_{j != i} (x_i - x_j); for the 2-adic subgroup this is
    x_i / n, computed directly for clarity (host-side, tiny)."""
    xs = gl64.two_adic_subgroup(subgroup_bits)
    n = len(xs)
    diffs = gl64.sub(xs[:, None], xs[None, :])
    diffs[np.arange(n), np.arange(n)] = 1
    prods = np.ones(n, dtype=np.uint64)
    for j in range(n):
        prods = gl64.mul(prods, diffs[:, j])
    return [int(w) for w in gl64.batch_inv(prods)]


def partial_interpolate_g(ctx, domain, values, weights, x, eval0, prod0):
    """One degree-bounded segment of the interpolation recurrence.

    domain/weights: host ints; values: list of ExtAlg; x/eval0/prod0: ExtAlg.
    Returns (eval, prod) after folding all the points in the segment."""
    e, p = eval0, prod0
    for x_i, v, w in zip(domain, values, weights):
        term = x - ExtAlg.from_base(ctx.constant(x_i), ctx)
        e = e * term + v.scalar_mul(ctx.constant(w)) * p
        p = p * term
    return e, p


class CosetInterpolationGate(Gate):
    def __init__(self, subgroup_bits: int, max_degree: int):
        assert max_degree > 1
        self.subgroup_bits = subgroup_bits
        n_points = 1 << subgroup_bits
        n_intermediates = (n_points - 2) // (max_degree - 1)
        # smallest degree giving the same number of intermediates
        self._degree = (n_points - 2) // (n_intermediates + 1) + 2
        self.barycentric_weights = _barycentric_weights(subgroup_bits)

    def id(self):
        ws = ", ".join(str(w) for w in self.barycentric_weights)
        return (f"CosetInterpolationGate {{ subgroup_bits: {self.subgroup_bits},"
                f" degree: {self._degree}, barycentric_weights: [{ws}] }}<D={D}>")

    def num_points(self):
        return 1 << self.subgroup_bits

    # -- wire layout (routed: shift, values, eval point, eval value) ---------
    def wire_shift(self):
        return 0

    def start_values(self):
        return 1

    def wires_value(self, i):
        return self.start_values() + i * D

    def start_evaluation_point(self):
        return self.start_values() + self.num_points() * D

    def wires_evaluation_point(self):
        return self.start_evaluation_point()

    def start_evaluation_value(self):
        return self.start_evaluation_point() + D

    def wires_evaluation_value(self):
        return self.start_evaluation_value()

    def start_intermediates(self):
        return self.start_evaluation_value() + D

    def num_routed_wires_used(self):
        return self.start_intermediates()

    def num_intermediates(self):
        return (self.num_points() - 2) // (self._degree - 1)

    def wires_intermediate_eval(self, i):
        return self.start_intermediates() + D * i

    def wires_intermediate_prod(self, i):
        return self.start_intermediates() + D * (self.num_intermediates() + i)

    def wires_shifted_evaluation_point(self):
        return self.start_intermediates() + D * 2 * self.num_intermediates()

    def num_wires(self):
        return self.start_intermediates() + D * (2 * self.num_intermediates() + 1)

    def degree(self):
        return self._degree

    def num_constraints(self):
        return D + D + 2 * D * self.num_intermediates()

    # -- segment boundaries ---------------------------------------------------
    def _segments(self):
        """[(start, end)] point ranges: first of length `degree`, then
        `degree - 1` each (the stored intermediate supplies the extra term)."""
        segs = [(0, self._degree)]
        for i in range(self.num_intermediates()):
            start = 1 + (self._degree - 1) * (i + 1)
            segs.append((start, min(start + self._degree - 1, self.num_points())))
        return segs

    def eval_unfiltered(self, ctx, vars: EvalVars):
        w = vars.local_wires

        def alg(start):
            return ExtAlg(w[start], w[start + 1])

        constraints = []
        shift = w[self.wire_shift()]
        z = alg(self.wires_evaluation_point())
        zs = alg(self.wires_shifted_evaluation_point())
        # z == zs * shift
        constraints.extend((z - zs.scalar_mul(shift)).components())

        domain = _subgroup(self.subgroup_bits)
        weights = self.barycentric_weights
        values = [alg(self.wires_value(i)) for i in range(self.num_points())]

        segs = self._segments()
        e, p = partial_interpolate_g(
            ctx, domain[segs[0][0]:segs[0][1]], values[segs[0][0]:segs[0][1]],
            weights[segs[0][0]:segs[0][1]], zs,
            ExtAlg(ctx.zero(), ctx.zero()), ExtAlg(ctx.one(), ctx.zero()))

        for i in range(self.num_intermediates()):
            ie = alg(self.wires_intermediate_eval(i))
            ip = alg(self.wires_intermediate_prod(i))
            constraints.extend((ie - e).components())
            constraints.extend((ip - p).components())
            s, t = segs[i + 1]
            e, p = partial_interpolate_g(ctx, domain[s:t], values[s:t],
                                         weights[s:t], zs, ie, ip)

        ev = alg(self.wires_evaluation_value())
        constraints.extend((ev - e).components())
        return constraints

    def generators(self, row, local_constants):
        gate = self
        n_pts = self.num_points()
        deps = [targets.wire(row, self.wire_shift())]
        deps += [targets.wire(row, self.wires_evaluation_point() + j)
                 for j in range(D)]
        for i in range(n_pts):
            deps += [targets.wire(row, self.wires_value(i) + j) for j in range(D)]
        outs = [targets.wire(row, self.wires_shifted_evaluation_point() + j)
                for j in range(D)]
        for i in range(self.num_intermediates()):
            outs += [targets.wire(row, self.wires_intermediate_eval(i) + j)
                     for j in range(D)]
            outs += [targets.wire(row, self.wires_intermediate_prod(i) + j)
                     for j in range(D)]
        outs += [targets.wire(row, self.wires_evaluation_value() + j)
                 for j in range(D)]

        return [GeneratorSpec(kind="custom", deps=deps, outs=outs,
                              fn=self.make_interpolant_fn(),
                              params=(self.subgroup_bits, self._degree),
                              name="coset_interp")]

    def make_interpolant_fn(self):
        """Witness fn for the interpolant trace (reconstructible from
        (subgroup_bits, degree) via plonk/generators.py)."""
        gate = self
        n_pts = self.num_points()

        def run(dep_vals: np.ndarray) -> list:
            shift = np.uint64(dep_vals[0])
            z = np.asarray(dep_vals[1:3], dtype=np.uint64)
            vals = dep_vals[3:].reshape(n_pts, 2).astype(np.uint64)
            zs = gl64ext.scalar_mul(z, gl64.inv(shift))
            domain = _subgroup(gate.subgroup_bits)
            weights = gate.barycentric_weights
            e = gl64ext.ZERO
            p = gl64ext.ONE
            out_vals = list(gl64.to_canonical(zs))
            segs = gate._segments()
            for si, (s, t) in enumerate(segs):
                for i in range(s, t):
                    term = gl64ext.sub(zs, gl64ext.from_base(np.uint64(domain[i])))
                    wv = gl64ext.scalar_mul(vals[i], np.uint64(weights[i]))
                    e = gl64ext.add(gl64ext.mul(e, term), gl64ext.mul(wv, p))
                    p = gl64ext.mul(p, term)
                if si < len(segs) - 1:
                    out_vals += list(gl64.to_canonical(e))
                    out_vals += list(gl64.to_canonical(p))
            out_vals += list(gl64.to_canonical(e))
            return out_vals

        return run
