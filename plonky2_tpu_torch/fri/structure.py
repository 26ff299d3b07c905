"""FRI instance descriptors (twin of reference fri/structure.rs).

An instance says which committed oracles exist, and which (oracle, poly)
pairs are opened at which extension-field points.  Openings carry the claimed
values in the same batch order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FriOracleInfo:
    num_polys: int
    blinding: bool


@dataclass(frozen=True)
class FriPolynomialInfo:
    oracle_index: int
    polynomial_index: int

    @staticmethod
    def from_range(oracle_index: int, start: int, stop: int) -> list:
        return [FriPolynomialInfo(oracle_index, i) for i in range(start, stop)]


@dataclass
class FriBatchInfo:
    point: np.ndarray  # (2,) extension element
    polynomials: list  # of FriPolynomialInfo


@dataclass
class FriInstanceInfo:
    oracles: list  # of FriOracleInfo
    batches: list  # of FriBatchInfo


@dataclass
class FriOpeningBatch:
    values: np.ndarray  # (k, 2) claimed evals at the batch point


@dataclass
class FriOpenings:
    batches: list  # of FriOpeningBatch
