"""FRI configuration (twin of reference fri/mod.rs:19-110 and
fri/reduction_strategies.rs:13-56)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FriReductionStrategy:
    """Fixed, ConstantArityBits, and MinSize
    (reference fri/reduction_strategies.rs:13-56)."""

    kind: str  # "fixed" | "constant_arity" | "min_size"
    arity_bits: tuple = ()
    final_poly_bits: int = 0
    num_queries_hint: int = 28  # MinSize sizes Merkle paths by query count

    @staticmethod
    def fixed(arities) -> "FriReductionStrategy":
        return FriReductionStrategy("fixed", tuple(arities))

    @staticmethod
    def constant_arity(arity_bits: int, final_poly_bits: int) -> "FriReductionStrategy":
        return FriReductionStrategy("constant_arity", (arity_bits,), final_poly_bits)

    @staticmethod
    def min_size(max_arity_bits: int | None = None,
                 num_queries: int = 28) -> "FriReductionStrategy":
        return FriReductionStrategy(
            "min_size", (max_arity_bits,) if max_arity_bits else (),
            num_queries_hint=num_queries)

    def reduction_arity_bits(
        self, degree_bits: int, rate_bits: int, cap_height: int
    ) -> list[int]:
        if self.kind == "fixed":
            return list(self.arity_bits)
        if self.kind == "min_size":
            max_bits = self.arity_bits[0] if self.arity_bits else 4
            return _min_size_arity_bits(degree_bits, rate_bits,
                                        self.num_queries_hint, max_bits)
        # ConstantArityBits (reference reduction_strategies.rs:39-50)
        (arity_bits,) = self.arity_bits
        result = []
        d = degree_bits
        while d > self.final_poly_bits and d + rate_bits - arity_bits >= cap_height:
            assert d >= arity_bits
            result.append(arity_bits)
            d -= arity_bits
        return result


def _min_size_arity_bits(degree_bits: int, rate_bits: int, num_queries: int,
                         max_arity_bits: int) -> list[int]:
    """Exhaustive search for the arity sequence minimizing estimated FRI
    proof size (reduction_strategies.rs:58-163).  Optimal sequences are
    monotonically non-increasing."""
    def proof_size(arities: tuple) -> int:
        d = 4  # size of a quartic-extension opening in the reference's model
        layer = degree_bits + rate_bits
        total = 0
        for a in arities:
            total += ((1 << a) - 1) * d * num_queries
            total += layer * 4 * num_queries
            layer -= a
        return total + d * (1 << (layer - rate_bits))

    def helper(prefix: tuple, cap: int):
        layer = degree_bits + rate_bits - sum(prefix)
        best, best_size = prefix, proof_size(prefix)
        limit = min(cap, layer - rate_bits)
        for nxt in range(1, limit + 1):
            cand, size = helper(prefix + (nxt,), nxt)
            if size < best_size:
                best, best_size = cand, size
        return best, best_size

    best, _ = helper((), max_arity_bits)
    return list(best)


@dataclass(frozen=True)
class FriConfig:
    """reference fri/mod.rs:19"""

    rate_bits: int
    cap_height: int
    proof_of_work_bits: int
    reduction_strategy: FriReductionStrategy
    num_query_rounds: int

    def num_cap_elements(self) -> int:
        return 1 << self.cap_height

    def fri_params(self, degree_bits: int, hiding: bool = False) -> "FriParams":
        arities = self.reduction_strategy.reduction_arity_bits(
            degree_bits, self.rate_bits, self.cap_height
        )
        return FriParams(self, hiding, degree_bits, tuple(arities))


def standard_fri_config() -> FriConfig:
    """The FRI half of standard_recursion_config (plonk/circuit_data.rs:72)."""
    return FriConfig(
        rate_bits=3,
        cap_height=4,
        proof_of_work_bits=16,
        reduction_strategy=FriReductionStrategy.constant_arity(4, 5),
        num_query_rounds=28,
    )


@dataclass(frozen=True)
class FriParams:
    """reference fri/mod.rs:62"""

    config: FriConfig
    hiding: bool
    degree_bits: int
    reduction_arity_bits: tuple

    def total_arities(self) -> int:
        return sum(self.reduction_arity_bits)

    def lde_bits(self) -> int:
        return self.degree_bits + self.config.rate_bits

    def lde_size(self) -> int:
        return 1 << self.lde_bits()

    def final_poly_bits(self) -> int:
        return self.degree_bits - self.total_arities()

    def final_poly_len(self) -> int:
        return 1 << self.final_poly_bits()
