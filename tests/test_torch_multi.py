"""The port's multi-table STARK prover (plonky2_tpu_torch.stark.multi) against
the JAX package on the CPU: the same CTL Z columns, identical
multi_proof_to_bytes under the Poseidon and the keccak configs, the port's
verifier accepting them and rejecting a tampered CTL Z, and the prover
refusing inconsistent traces.

The tables are tests/test_ctl.py's three-table CTL statement and
tests/test_zkevm.py's joint Logic + Memory + bus statement, rebuilt in
plonky2_tpu_torch.models.multi_table; each JAX proof is made once per module.
"""

import copy

import numpy as np
import pytest
import torch

import test_ctl as jctl_demo
import test_zkevm as jzkevm_demo
from plonky2_tpu.stark.config import StarkConfig as JStarkConfig
from plonky2_tpu.iop.challenger import Challenger as JChallenger
from plonky2_tpu.stark.ctl import cross_table_lookup_data as jctl_data
from plonky2_tpu.stark.ctl import \
    get_grand_product_challenge_set as jget_grand_product_challenge_set
from plonky2_tpu.stark.multi import prove_multi_table as jprove
from plonky2_tpu.zkevm.serialization import multi_proof_to_bytes as jto_bytes
from plonky2_tpu_torch.field import gl64
from plonky2_tpu_torch.field.goldilocks import GF
from plonky2_tpu_torch.iop.challenger import Challenger
from plonky2_tpu_torch.models.multi_table import ctl_demo, zkevm_bus_demo
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.ctl import get_grand_product_challenge_set
from plonky2_tpu_torch.stark.multi import (cross_table_lookup_data_gf,
                                           prove_multi_table,
                                           verify_multi_table)
from plonky2_tpu_torch.zkevm.serialization import (multi_proof_from_bytes,
                                                   multi_proof_to_bytes)

HASHERS = ["poseidon", "keccak"]


def jax_ctl_demo():
    mul = jctl_demo._mul_trace()
    req1, req2 = jctl_demo._req_traces(mul)
    return ([jctl_demo.MulStark(), jctl_demo.ReqStark(),
             jctl_demo.Req2Stark()], jctl_demo._ctls(), [mul, req1, req2])


@pytest.fixture(scope="module", params=HASHERS)
def ctl_demo_proof(request):
    """(hasher, the JAX package's proof bytes of the three-table demo)."""
    hasher = request.param
    starks, ctls, traces = jax_ctl_demo()
    proof = jprove(starks, ctls, JStarkConfig(hasher=hasher), traces)
    return hasher, jto_bytes(proof, hasher=hasher)


@pytest.fixture(scope="module")
def port_ctl_demo_proofs():
    """The port's proof of the three-table demo under each hasher."""
    starks, ctls, traces = ctl_demo()
    return {h: prove_multi_table(starks, ctls, StarkConfig(hasher=h), traces,
                                 device="cpu") for h in HASHERS}


def test_demo_traces_equal_the_jax_tests():
    for (_, _, got), (_, _, want) in ((ctl_demo(), jax_ctl_demo()),
                                      (zkevm_bus_demo(),
                                       jzkevm_demo._joint_traces())):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("demo", ["ctl_demo", "zkevm_bus_demo"])
def test_ctl_z_columns_match_jax(demo):
    """The prover's device CTL Z columns equal the JAX package's host
    cross_table_lookup_data, column by column and in the same order."""
    _, ctls, traces = {"ctl_demo": ctl_demo,
                       "zkevm_bus_demo": zkevm_bus_demo}[demo]()
    _, jctls, _ = {"ctl_demo": jax_ctl_demo,
                   "zkevm_bus_demo": jzkevm_demo._joint_traces}[demo]()
    got = cross_table_lookup_data_gf(
        [GF.from_u64(t, "cpu") for t in traces], ctls,
        get_grand_product_challenge_set(Challenger(), 2))
    want = jctl_data(traces, jctls,
                     jget_grand_product_challenge_set(JChallenger(), 2))
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            np.stack([zc.z.to_u64() for zc in g.zs_columns]), w.z_polys())


def test_ctl_demo_bytes_match_jax(ctl_demo_proof, port_ctl_demo_proofs):
    hasher, want = ctl_demo_proof
    proof = port_ctl_demo_proofs[hasher]
    got = multi_proof_to_bytes(proof, hasher=hasher)
    assert got == want
    starks, ctls, _ = ctl_demo()
    config = StarkConfig(hasher=hasher)
    verify_multi_table(starks, ctls, proof, config)
    back = multi_proof_from_bytes(got, hasher=hasher)
    assert multi_proof_to_bytes(back, hasher=hasher) == got
    verify_multi_table(starks, ctls, back, config)
    if hasher == "keccak":
        assert back.stark_proofs[0].trace_cap.data.dtype == np.uint8


@pytest.mark.parametrize("hasher", HASHERS)
def test_tampered_ctl_z_rejected(port_ctl_demo_proofs, hasher):
    starks, ctls, _ = ctl_demo()
    proof = copy.deepcopy(port_ctl_demo_proofs[hasher])
    last = proof.stark_proofs[0].openings.ctl_zs_last
    last[0] = gl64.add(last[0], np.uint64(1))
    with pytest.raises(AssertionError):
        verify_multi_table(starks, ctls, proof, StarkConfig(hasher=hasher))


def test_inconsistent_traces_rejected():
    starks, ctls, traces = ctl_demo()
    traces[1][2, 0] = gl64.add(traces[1][2, 0], np.uint64(1))
    with pytest.raises(ValueError, match="CTL multisets"):
        prove_multi_table(starks, ctls, StarkConfig(), traces, device="cpu")


@pytest.fixture(scope="module", params=HASHERS)
def jax_bus_demo_bytes(request):
    """(hasher, the JAX package's proof bytes of the Logic + Memory + bus
    tables)."""
    hasher = request.param
    starks, ctls, traces = jzkevm_demo._joint_traces()
    proof = jprove(starks, ctls, JStarkConfig(hasher=hasher), traces)
    return hasher, jto_bytes(proof, hasher=hasher)


def test_zkevm_bus_demo_bytes_match_jax(jax_bus_demo_bytes):
    hasher, want = jax_bus_demo_bytes
    starks, ctls, traces = zkevm_bus_demo()
    config = StarkConfig(hasher=hasher)
    proof = prove_multi_table(starks, ctls, config, traces, device="cpu")
    assert multi_proof_to_bytes(proof, hasher=hasher) == want
    verify_multi_table(starks, ctls, proof, config)


def test_prove_multi_table_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    starks, ctls, traces = ctl_demo()
    with pytest.raises(RuntimeError, match="CUDA"):
        prove_multi_table(starks, ctls, StarkConfig(), traces)
