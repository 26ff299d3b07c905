"""The rule by which the port's field ops run as csrc/field.cu launches
(field/goldilocks.py kernel_layout, run_kernel), on the CPU: which tensors
take the torch path, which layouts a CUDA operand is refused in, and the
layout each operand is handed to a kernel in."""

import numpy as np
import pytest
import torch

from plonky2_tpu_torch.field import extension as ext
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field.extension import GF2
from plonky2_tpu_torch.field.goldilocks import GF, kernel_layout

ENTRIES = [gl.ADD, gl.SUB, gl.MUL, gl.NEG, gl.CANONICAL, ext.MUL, ext.SQUARE]


def i64(shape, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 64, size=int(np.prod(shape)), dtype=np.uint64)
    return torch.from_numpy(vals.view(np.int64).reshape(shape).copy())


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 4, 5),
                                   (2, 1, 3, 2, 2)])
def test_cpu_tensors_take_the_torch_path(shape):
    """On CPU tensors, of any rank, every op returns its torch version's
    values and launches no entry."""
    x, y = i64(shape, 1), i64(shape, 2)
    calls = [k.calls for k in ENTRIES]
    for op in ("add", "sub", "mul"):
        assert torch.equal(getattr(gl, op)(x, y),
                           getattr(gl, f"{op}_torch")(x, y))
    for op in ("neg", "canonical"):
        assert torch.equal(getattr(gl, op)(x), getattr(gl, f"{op}_torch")(x))
    u, w = GF2(GF(x), GF(y)), GF2(GF(y), GF(x))
    for got, want in ((u * w, ext.mul_torch(u, w)),
                      (u.square(), ext.square_torch(u))):
        assert torch.equal(got.a.v, want.a.v) and torch.equal(got.b.v, want.b.v)
    assert [k.calls for k in ENTRIES] == calls


class CudaLike(torch.Tensor):
    """A CPU tensor that reports itself on CUDA, so run_kernel takes the
    kernel branch up to the launch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("xs", [
    (i64((2, 2, 3, 1, 2), 1).transpose(0, 4), i64((2, 1, 3, 2, 2), 2)),
    (i64((2, 1, 3, 2, 2), 1), i64((), 2)),
    (i64((2, 3), 1), i64((4, 1, 1, 1, 1), 2)),
    (i64((3,), 1), i64((3,), 2).to(torch.int32)),
    (i64((3,), 1), torch.empty(3, dtype=torch.int64, device="meta")),
], ids=["rank5", "rank5_scalar", "rank5_broadcast", "int32", "two_devices"])
def test_rule_refuses_what_the_kernels_do_not_take(xs):
    """Rank above 4 (after broadcasting, or of a strided view), another
    dtype or another device: the rule returns None, and on a CUDA operand
    the op raises ValueError, naming the entry, before any launch."""
    assert kernel_layout(*xs) is None
    calls = gl.ADD.calls
    with pytest.raises(ValueError, match="gl_add"):
        gl.run_kernel(gl.ADD, 1, xs[0].as_subclass(CudaLike), *xs[1:])
    assert gl.ADD.calls == calls


def test_contiguous_operands_of_one_shape_are_flat_at_any_rank():
    x, y = i64((2, 1, 3, 2, 2), 1), i64((2, 1, 3, 2, 2), 2)
    shape, dims, strides = kernel_layout(x, y)
    assert tuple(shape) == (2, 1, 3, 2, 2)
    assert dims == (1, 1, 1, 24)
    assert strides == ((0, 0, 0, 1), (0, 0, 0, 1))


def test_contiguous_operands_of_one_shape_are_flat():
    x, y = i64((3, 4, 5), 1), i64((3, 4, 5), 2)
    shape, dims, strides = kernel_layout(x, y)
    assert tuple(shape) == (3, 4, 5)
    assert dims == (1, 1, 1, 60)
    assert strides == ((0, 0, 0, 1), (0, 0, 0, 1))


@pytest.mark.parametrize("case", ["scalar", "scalar_left", "k1", "k1_left",
                                  "halves", "rank4_permuted"])
def test_strides_of_broadcast_and_strided_views(case):
    """Each operand's element strides over the rank-4 output dims: 0 on a
    broadcast dimension, a view's own strides otherwise; the view's offset
    stays in its data pointer."""
    k, n = 3, 8
    full = i64((k, n), 1)
    col = i64((k, 1), 2)
    zero_d = i64((), 3)
    if case == "scalar":
        xs, want = (full, zero_d), ((1, 1, k, n), [(0, 0, n, 1), (0, 0, 0, 0)])
    elif case == "scalar_left":
        xs, want = (zero_d, full), ((1, 1, k, n), [(0, 0, 0, 0), (0, 0, n, 1)])
    elif case == "k1":
        xs, want = (full, col), ((1, 1, k, n), [(0, 0, n, 1), (0, 0, 1, 0)])
    elif case == "k1_left":
        xs, want = (col, full), ((1, 1, k, n), [(0, 0, 1, 0), (0, 0, n, 1)])
    elif case == "halves":
        # GF.sum's pairwise step: x[..., 0::2] + x[..., 1::2]
        xs = (full[..., 0::2], full[..., 1::2])
        want = ((1, 1, k, n // 2), [(0, 0, n, 2), (0, 0, n, 2)])
        assert xs[1].data_ptr() - xs[0].data_ptr() == 8
    else:
        a = i64((2, 3, 4, 5), 4).transpose(0, 3)          # (5, 3, 4, 2)
        b = i64((5, 4, 3, 2), 5).permute(0, 2, 1, 3)     # (5, 3, 4, 2)
        xs = (a, b)
        want = ((5, 3, 4, 2), [(1, 20, 5, 60), (24, 2, 6, 1)])
    shape, dims, strides = kernel_layout(*xs)
    assert dims == want[0]
    assert tuple(shape) == tuple(torch.broadcast_shapes(*(x.shape for x in xs)))
    assert [tuple(s) for s in strides] == want[1]
    # the strides address every operand element the output position needs
    for x, st in zip(xs, strides):
        base = torch.as_strided(x, dims, st)
        assert torch.equal(base.reshape(shape), x.expand(shape))
