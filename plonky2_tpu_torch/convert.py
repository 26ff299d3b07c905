"""Carry values from the JAX package (plonky2_tpu) into this port.

Everything here duck-types on attributes, so the port needs no import of the
JAX package: a JAX ``GF`` is read through its ``lo``/``hi`` u32 planes, a
host array as u64 values, and JAX ``StarkConfig``/``FriConfig`` objects
through their fields.
"""

from __future__ import annotations

import numpy as np

from .field.goldilocks import GF
from .fri.config import FriConfig, FriReductionStrategy
from .stark.config import StarkConfig


def gf_from_jax(x, device) -> GF:
    """A JAX GF (planes ``lo``, ``hi``) or a host u64 array -> port GF."""
    if hasattr(x, "lo") and hasattr(x, "hi"):
        lo = np.asarray(x.lo, dtype=np.uint64)
        hi = np.asarray(x.hi, dtype=np.uint64)
        return GF.from_u64((hi << np.uint64(32)) | lo, device)
    return GF.from_u64(np.asarray(x, dtype=np.uint64), device)


def fri_config_from_jax(cfg) -> FriConfig:
    rs = cfg.reduction_strategy
    return FriConfig(
        rate_bits=cfg.rate_bits,
        cap_height=cfg.cap_height,
        proof_of_work_bits=cfg.proof_of_work_bits,
        reduction_strategy=FriReductionStrategy(
            rs.kind, tuple(rs.arity_bits), rs.final_poly_bits,
            rs.num_queries_hint),
        num_query_rounds=cfg.num_query_rounds,
    )


def stark_config_from_jax(cfg) -> StarkConfig:
    return StarkConfig(
        security_bits=cfg.security_bits,
        num_challenges=cfg.num_challenges,
        fri_config=fri_config_from_jax(cfg.fri_config),
        hasher=cfg.hasher,
    )
