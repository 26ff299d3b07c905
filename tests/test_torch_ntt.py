"""The port's NTT module (plonky2_tpu_torch.field.ntt) against the JAX
package's field/ntt.py, the MXU NTT's CPU twins (ops/mxu_ntt_pallas.py) and
the host twins gl64.ntt_np/lde_np, on the CPU, exactly."""

import numpy as np
import pytest

from plonky2_tpu.field import gl64 as jgl64
from plonky2_tpu.field import ntt as jntt
from plonky2_tpu.field.extension import GF2 as JGF2
from plonky2_tpu.field.goldilocks import GF as JGF
from plonky2_tpu.ops.mxu_ntt_pallas import dft_matrix_digits, mxu_dft_jnp, mxu_ntt
from plonky2_tpu_torch.field import ntt
from plonky2_tpu_torch.field.extension import GF2
from plonky2_tpu_torch.field.goldilocks import GF

P = jgl64.ORDER_INT
SHIFT = 7


def rand(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("shape", [(1,), (2,), (32,), (2, 128)])
def test_transforms_match_jax(rng, shape):
    c = rand(rng, shape)
    x, j = GF.from_u64(c, "cpu"), JGF.from_u64(c)
    assert np.array_equal(ntt.ntt(x).to_u64(), jntt.ntt(j).to_u64())
    assert np.array_equal(ntt.intt(x).to_u64(), jntt.intt(j).to_u64())
    assert np.array_equal(ntt.coset_ntt(x, SHIFT).to_u64(),
                          jntt.coset_ntt(j, SHIFT).to_u64())
    assert np.array_equal(ntt.coset_intt(x, SHIFT).to_u64(),
                          jntt.coset_intt(j, SHIFT).to_u64())


@pytest.mark.parametrize("log_n", [1, 5, 9, 12])
def test_transforms_match_host_twin(rng, log_n):
    c = rand(rng, (2, 1 << log_n))
    x = GF.from_u64(c, "cpu")
    assert np.array_equal(ntt.ntt(x).to_u64(), jgl64.ntt_np(c))
    assert np.array_equal(ntt.intt(x).to_u64(), jgl64.intt_np(c))
    assert np.array_equal(ntt.coset_ntt(x, SHIFT).to_u64(), jgl64.coset_ntt_np(c, SHIFT))
    assert np.array_equal(ntt.coset_intt(ntt.coset_ntt(x, SHIFT), SHIFT).to_u64(),
                          jgl64.to_canonical(c))


@pytest.mark.parametrize("log_n,rate_bits", [(1, 1), (4, 3), (8, 2), (10, 1),
                                             (12, 1), (12, 3)])
def test_lde_matches_host_twin(rng, log_n, rate_bits):
    c = rand(rng, (3, 1 << log_n))
    got = ntt.lde(GF.from_u64(c, "cpu"), rate_bits, SHIFT).to_u64()
    assert np.array_equal(got, jgl64.lde_np(c, rate_bits, SHIFT))
    assert np.array_equal(ntt.lde_torch(GF.from_u64(c, "cpu"), rate_bits, 1).to_u64(),
                          jgl64.ntt_np(np.concatenate(
                              [c, np.zeros((3, (1 << (log_n + rate_bits)) - (1 << log_n)),
                                           np.uint64)], axis=-1)))


@pytest.mark.parametrize("log_n,rate_bits", [(5, 1), (5, 3)])
def test_lde_and_ext_wrappers_match_jax(rng, log_n, rate_bits):
    c = rand(rng, (2, 1 << log_n))
    assert np.array_equal(ntt.lde(GF.from_u64(c, "cpu"), rate_bits, SHIFT).to_u64(),
                          jntt.lde(JGF.from_u64(c), rate_bits, SHIFT).to_u64())
    x = GF2.from_u64_pair(c[0], c[1], "cpu")
    j = JGF2.from_u64_pair(c[0], c[1])
    for port, ref in [(ntt.lde_ext(x, rate_bits, SHIFT), jntt.lde_ext(j, rate_bits, SHIFT)),
                      (ntt.ntt_ext(x), jntt.ntt_ext(j)),
                      (ntt.intt_ext(x), jntt.intt_ext(j)),
                      (ntt.coset_ntt_ext(x, SHIFT), jntt.coset_ntt_ext(j, SHIFT)),
                      (ntt.coset_intt_ext(x, SHIFT), jntt.coset_intt_ext(j, SHIFT))]:
        assert np.array_equal(port.to_u64(), ref.to_u64())


def test_dft_torch_matches_mxu_dft_twin():
    """The kernel's building block (a DFT along axis 0) at the shape of
    tests/test_mxu_ntt.py, with and without the twiddle post-multiply."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    n1 = 16
    c = rng.integers(0, P, size=(n1, 8), dtype=np.uint64)
    want = mxu_dft_jnp(jnp.asarray(dft_matrix_digits(n1)), JGF.from_u64(c)).to_u64()
    got = ntt.dft_torch(GF.from_u64(c, "cpu")).to_u64()
    assert np.array_equal(got, jgl64.to_canonical(want))
    tw = rand(rng, (n1, 8))
    got = ntt.dft_torch(GF.from_u64(c, "cpu"), GF.from_u64(tw, "cpu")).to_u64()
    assert np.array_equal(got, jgl64.mul(jgl64.to_canonical(want), tw) % np.uint64(P))


@pytest.mark.parametrize("log1,log2,batch", [(3, 3, 2), (4, 4, 3), (4, 5, 2)])
def test_ntt_torch_matches_mxu_four_step_twin(log1, log2, batch):
    rng = np.random.default_rng(2)
    c = rng.integers(0, P, size=(batch, 1 << (log1 + log2)), dtype=np.uint64)
    want = mxu_ntt(JGF.from_u64(c), log1, log2, use_pallas=False).to_u64()
    got = ntt.ntt_torch(GF.from_u64(c, "cpu")).to_u64()
    assert np.array_equal(got, jgl64.to_canonical(want))


def test_ntt_dispatch_is_by_device(rng):
    """A CPU tensor runs the plain versions; the kernel wrapper refuses it."""
    x = GF.from_u64(rand(rng, (2, 64)), "cpu")
    before = ntt.NTT.launches
    for out in (ntt.ntt(x), ntt.intt(x), ntt.coset_ntt(x, SHIFT),
                ntt.coset_intt(x, SHIFT)):
        assert out.device.type == "cpu"
    assert ntt.NTT.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ntt.ntt_cuda(x.v)
