"""The port's zkEVM (plonky2_tpu_torch.zkevm) against the JAX package on the
CPU: the kernel assembles to the same code, the simulator and trace
generation give the same seven tables for tests/test_zkevm_cpu.py's proving
program, the CTL wiring is the same, the transfer block simulates to the
same public values, and the port proves and verifies the program with its
ROM binding (slow here: chip_smoke.py proves the transfer block on the
card)."""

import dataclasses

import numpy as np
import pytest

from plonky2_tpu.zkevm import generation as jgeneration
from plonky2_tpu.zkevm.kernel import KERNEL as JKERNEL
from plonky2_tpu.zkevm.kernel import assemble as jassemble
from plonky2_tpu.zkevm.transfer import simulate_transfer as jsimulate_transfer
from plonky2_tpu_torch.stark.testing import check_constraints_on_trace
from plonky2_tpu_torch.zkevm import generation, mpt
from plonky2_tpu_torch.zkevm.kernel import KERNEL, assemble
from plonky2_tpu_torch.zkevm.transfer import (BlockMetadata, GenerationInputs,
                                              Transfer, simulate_transfer)

# tests/test_zkevm_cpu.py test_prove_verify_with_rom_binding's program
PROGRAM = ("global user_main:\n PUSH 5\n PUSH 3\n AND\n PUSH 2\n OR\n"
           " STOP\n")
ARITH_LIMB_BITS = 8


def program_code() -> list:
    code, _ = assemble([PROGRAM], base=KERNEL.user_base)
    return code


@pytest.fixture(scope="module")
def program_tables():
    """(port (starks, traces), JAX (starks, traces)) of PROGRAM."""
    code = program_code()
    port = generation.generate_traces(generation.Simulator(code),
                                      arith_limb_bits=ARITH_LIMB_BITS)[:2]
    jax = jgeneration.generate_traces(jgeneration.Simulator(code),
                                      arith_limb_bits=ARITH_LIMB_BITS)[:2]
    return port, jax


def test_kernel_and_program_assemble_like_jax():
    assert KERNEL.user_base == JKERNEL.user_base
    assert KERNEL.code == JKERNEL.code
    assert program_code() == jassemble([PROGRAM], base=JKERNEL.user_base)[0]


def test_generate_traces_match_jax(program_tables):
    (starks, traces), (jstarks, jtraces) = program_tables
    assert [type(s).__name__ for s in starks] == \
        [type(s).__name__ for s in jstarks]
    for stark, trace, jtrace in zip(starks, traces, jtraces):
        assert trace.shape == (stark.COLUMNS, trace.shape[1])
        np.testing.assert_array_equal(trace, jtrace)


def test_cross_table_lookups_match_jax(program_tables):
    (starks, _), (jstarks, _) = program_tables
    ctls = generation.all_cross_table_lookups(starks)
    jctls = jgeneration.all_cross_table_lookups(jstarks)
    assert [dataclasses.astuple(c) for c in ctls] == \
        [dataclasses.astuple(c) for c in jctls]


@pytest.mark.parametrize("table", range(5))
def test_program_tables_satisfy_their_air(program_tables, table):
    (starks, traces), _ = program_tables
    check_constraints_on_trace(starks[table], traces[table])


# tests/test_zkevm_cpu.py's COMPREHENSIVE program: keccak, loops, EXP, memory,
# so all seven tables (the keccak sponge and keccak-f ones included)
COMPREHENSIVE = """
global user_main:
    PUSH 0x61
    PUSH 10
    MSTORE8
    PUSH 1
    PUSH 10
    KECCAK256
    PUSH 0
    MSTORE
    PUSH 3
loop:
    JUMPDEST
    DUP1
    ISZERO
    PUSH done
    JUMPI
    PUSH 1
    SWAP1
    SUB
    PUSH loop
    JUMP
done:
    JUMPDEST
    POP
    PUSH 0
    MLOAD
    PUSH 0xff
    AND
    PUSH 2
    EXP
    STOP
"""


@pytest.fixture(scope="module")
def seven_tables():
    """The port's (starks, traces) of COMPREHENSIVE and the JAX traces."""
    code, _ = assemble([COMPREHENSIVE], base=KERNEL.user_base)
    starks, traces, _ = generation.generate_traces(
        generation.Simulator(code), arith_limb_bits=ARITH_LIMB_BITS)
    _, jtraces, _ = jgeneration.generate_traces(
        jgeneration.Simulator(code), arith_limb_bits=ARITH_LIMB_BITS)
    return starks, traces, jtraces


@pytest.mark.parametrize("table", range(7))
def test_seven_tables_match_jax_and_satisfy_their_air(seven_tables, table):
    starks, traces, jtraces = seven_tables
    assert [type(s).__name__ for s in starks] == [
        "CpuStark", "MemoryStark", "LogicStark", "ArithmeticStark",
        "KeccakSpongeStark", "KeccakStark", "ProgramStark"]
    np.testing.assert_array_equal(traces[table], jtraces[table])
    check_constraints_on_trace(starks[table], traces[table])


A = bytes.fromhex("a94f5374fce5edbc8e2a8697c15331677e6ebf0b")
B = bytes.fromhex("095e7baea6a6c7c4c2dfeb977efac326af552d87")
COINBASE = bytes.fromhex("2adc25665018aa1fe0e6bc666dac8fc2697ff9ba")


def transfer_inputs(mod_mpt, mod_types):
    """tests/test_zkevm_transfer.py's _base_inputs(), from either package."""
    block_metadata, generation_inputs, transfer = mod_types
    state = mod_mpt.trie_insert(mod_mpt.Empty(), mod_mpt.state_key(A),
                                mod_mpt.Account(nonce=5,
                                                balance=10 ** 18).encode())
    return generation_inputs(
        txn=transfer(sender=A, to=B, value=4 * 10 ** 15, nonce=5,
                     gas_price=10),
        tries=mod_mpt.TrieInputs(state_trie=state),
        block_metadata=block_metadata(beneficiary=COINBASE, number=1,
                                      timestamp=1_000_000))


def test_transfer_public_values_match_jax():
    from plonky2_tpu.zkevm import mpt as jmpt
    from plonky2_tpu.zkevm import transfer as jtransfer
    inputs = transfer_inputs(mpt, (BlockMetadata, GenerationInputs, Transfer))
    jinputs = transfer_inputs(jmpt, (jtransfer.BlockMetadata,
                                     jtransfer.GenerationInputs,
                                     jtransfer.Transfer))
    sim, pv = simulate_transfer(inputs, trace=False)
    jsim, jpv = jsimulate_transfer(jinputs, trace=False)
    assert dataclasses.astuple(pv) == dataclasses.astuple(jpv)
    assert sim.final_stack == jsim.final_stack


@pytest.mark.slow
def test_prove_verify_with_rom_binding():
    """The port proves PROGRAM on the CPU (5 tables, 84 FRI queries each)
    and verify_program_proof pins the ROM commitment to the public code;
    about 70 s to prove and 30 s per verify on a CPU."""
    code = program_code()
    proof, starks, ctls, sim = generation.prove_program(
        code, arith_limb_bits=ARITH_LIMB_BITS, device="cpu")
    assert sim.final_stack == [(5 & 3) | 2]
    generation.verify_program_proof(starks, ctls, proof, user_code=code,
                                    device="cpu")
    other = list(code)
    other[0] = (0x60, 6)
    with pytest.raises(AssertionError, match="program ROM"):
        generation.verify_program_proof(starks, ctls, proof, user_code=other,
                                        device="cpu")
