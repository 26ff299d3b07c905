"""The port's gate test harness (plonky2_tpu_torch.plonk.gates.testing) on
every gate of tests/test_gates.py's ALL_GATES, on the CPU with the same
seeds: each gate's constraints stay within its degree bound and its
base-field and extension evaluations agree.  One case per gate and check."""

import pytest

from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.gates.arithmetic import ArithmeticGate
from plonky2_tpu_torch.plonk.gates.ext_gates import (ArithmeticExtensionGate,
                                                     MulExtensionGate,
                                                     PoseidonMdsGate,
                                                     ReducingExtensionGate,
                                                     ReducingGate)
from plonky2_tpu_torch.plonk.gates.interpolation import CosetInterpolationGate
from plonky2_tpu_torch.plonk.gates.lookup import LookupGate, LookupTableGate
from plonky2_tpu_torch.plonk.gates.misc import (BaseSumGate,
                                                ExponentiationGate,
                                                RandomAccessGate)
from plonky2_tpu_torch.plonk.gates.poseidon_gate import PoseidonGate
from plonky2_tpu_torch.plonk.gates.simple import (ConstantGate, NoopGate,
                                                  PublicInputGate)
from plonky2_tpu_torch.plonk.gates.testing import (check_eval_consistency,
                                                   check_low_degree)

CONFIG = CircuitConfig.standard_recursion_config()

# tests/test_gates.py's ALL_GATES: 18 instances of 16 gate types
ALL_GATES = [
    ArithmeticGate.new_from_config(CONFIG),
    ArithmeticExtensionGate.new_from_config(CONFIG),
    MulExtensionGate.new_from_config(CONFIG),
    BaseSumGate(11, base=2),
    BaseSumGate(4, base=4),
    ConstantGate(2),
    ExponentiationGate(7),
    NoopGate(),
    PublicInputGate(),
    PoseidonGate(),
    PoseidonMdsGate(),
    RandomAccessGate.new_from_config(CONFIG, 4),
    ReducingGate(21),
    ReducingExtensionGate(12),
    CosetInterpolationGate(4, 8),
    CosetInterpolationGate(2, 8),
    LookupGate(40, 0),
    LookupTableGate(26, 0, 0),
]


def test_all_gates_match_the_jax_list():
    from test_gates import ALL_GATES as JAX_GATES
    assert [g.id() for g in ALL_GATES] == [g.id() for g in JAX_GATES]


@pytest.mark.parametrize("gate", ALL_GATES, ids=lambda g: g.id()[:40])
def test_gate_low_degree(gate):
    check_low_degree(gate, device="cpu")


@pytest.mark.parametrize("gate", ALL_GATES, ids=lambda g: g.id()[:40])
def test_gate_eval_consistency(gate):
    check_eval_consistency(gate, device="cpu")
