"""The port's STARK test harness (plonky2_tpu_torch/stark/testing.py, twin of
starky's stark_testing.rs) against the JAX package's, on the CPU: both accept
the FibonacciStark and the zkEVM MemoryStark, and both reject a STARK whose
constraint is of too high a degree and one whose circuit evaluation differs
from its host evaluation."""

import numpy as np
import pytest

from plonky2_tpu.fri.config import FriConfig as JFriConfig
from plonky2_tpu.fri.config import FriReductionStrategy as JFriReductionStrategy
from plonky2_tpu.plonk.config import CircuitConfig as JCircuitConfig
from plonky2_tpu.stark.fibonacci import FibonacciStark as JFibonacciStark
from plonky2_tpu.stark.testing import \
    test_stark_circuit_constraints as jax_circuit_constraints, \
    test_stark_low_degree as jax_low_degree
from plonky2_tpu.zkevm import MemoryStark as JMemoryStark
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.stark.fibonacci import FibonacciStark
from plonky2_tpu_torch.stark.testing import \
    test_stark_circuit_constraints as port_circuit_constraints, \
    test_stark_low_degree as port_low_degree
from plonky2_tpu_torch.zkevm import MemoryStark


def small_config(pkg: str):
    """The fast config of tests/test_stark_testing.py, in either package."""
    config, fri, strategy = ((JCircuitConfig, JFriConfig, JFriReductionStrategy)
                             if pkg == "jax" else
                             (CircuitConfig, FriConfig, FriReductionStrategy))
    return config(fri_config=fri(
        rate_bits=3, cap_height=4, proof_of_work_bits=8,
        reduction_strategy=strategy.constant_arity(4, 5), num_query_rounds=4))


def cubed(fibonacci):
    """A FibonacciStark with a degree-3 transition constraint that still
    declares constraint degree 2."""
    class Cubed(fibonacci):
        def eval_generic(self, ctx, vars, yield_constr):
            super().eval_generic(ctx, vars, yield_constr)
            x = vars.local_values[0]
            yield_constr.constraint_transition(x * x * x - vars.next_values[2])
    return Cubed(1 << 5)


def circuit_differs(fibonacci):
    """A FibonacciStark that adds a constraint only when evaluated in a
    circuit."""
    class CircuitDiffers(fibonacci):
        def eval_generic(self, ctx, vars, yield_constr):
            super().eval_generic(ctx, vars, yield_constr)
            if type(ctx).__name__ == "CircuitCtx":
                yield_constr.constraint(vars.local_values[0]
                                        - vars.local_values[1])
    return CircuitDiffers(1 << 5)


PAIRS = {"fibonacci": (lambda: JFibonacciStark(1 << 5),
                       lambda: FibonacciStark(1 << 5)),
         "memory": (JMemoryStark, MemoryStark)}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_low_degree_accepts_like_jax(name):
    jax_stark, port_stark = PAIRS[name]
    jax_low_degree(jax_stark())
    port_low_degree(port_stark(), device="cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_low_degree_rejects_like_jax(seed):
    with pytest.raises(AssertionError, match="exceeds bound"):
        jax_low_degree(cubed(JFibonacciStark), np.random.default_rng(seed))
    with pytest.raises(AssertionError, match="exceeds bound"):
        port_low_degree(cubed(FibonacciStark), np.random.default_rng(seed),
                        device="cpu")


def test_circuit_constraints_accept_like_jax():
    jax_circuit_constraints(JFibonacciStark(1 << 5), small_config("jax"))
    port_circuit_constraints(FibonacciStark(1 << 5), small_config("port"),
                             device="cpu")


def test_circuit_constraints_reject_like_jax():
    with pytest.raises(AssertionError, match="disagrees"):
        jax_circuit_constraints(circuit_differs(JFibonacciStark),
                                small_config("jax"))
    with pytest.raises(AssertionError, match="disagrees"):
        port_circuit_constraints(circuit_differs(FibonacciStark),
                                 small_config("port"), device="cpu")
