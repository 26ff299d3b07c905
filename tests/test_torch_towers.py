"""The port's quartic and quintic extension towers (plonky2_tpu_torch.field
.towers) against the JAX package's, on tests/test_towers.py's cases: the
same random elements give the same products, inverses, Frobenius images
and powers, and the port's values satisfy the field laws."""

import numpy as np
import pytest

from plonky2_tpu.field import towers as jtowers
from plonky2_tpu_torch.field import gl64, towers

P = gl64.ORDER_INT
TOWERS = [("QUARTIC", 4), ("QUINTIC", 5)]


@pytest.mark.parametrize("name,d", TOWERS, ids=["D4", "D5"])
def test_tower_properties(name, d):
    F, J = getattr(towers, name), getattr(jtowers, name)
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, P, size=F.D, dtype=np.uint64) for _ in range(3))
    s = int(rng.integers(1, P, dtype=np.uint64))
    assert F.D == J.D == d and F.W == J.W
    # every operation gives the JAX package's values
    for got, want in [(F.mul(a, b), J.mul(a, b)), (F.add(a, c), J.add(a, c)),
                      (F.sub(a, c), J.sub(a, c)), (F.inv(a), J.inv(a)),
                      (F.frobenius(a), J.frobenius(a)),
                      (F.frobenius(a, 3), J.frobenius(a, 3)),
                      (F.pow_int(a, 12345), J.pow_int(a, 12345)),
                      (F.scalar_mul(a, s), J.scalar_mul(a, s)),
                      (F.from_base(np.uint64(s)), J.from_base(np.uint64(s)))]:
        assert np.array_equal(gl64.to_canonical(got), gl64.to_canonical(want))
    # ring laws, inverse, Frobenius of order D, the base field's embedding
    assert F.equal(F.mul(F.mul(a, b), c), F.mul(a, F.mul(b, c)))
    assert F.equal(F.mul(a, F.add(b, c)), F.add(F.mul(a, b), F.mul(a, c)))
    assert F.equal(F.mul(a, F.inv(a)), F.one())
    assert F.equal(F.frobenius(a), F.pow_int(a, P))
    x = a
    for _ in range(F.D):
        x = F.frobenius(x)
    assert F.equal(x, a)
    assert F.equal(F.mul(F.from_base(np.uint64(s)), a), F.scalar_mul(a, s))


@pytest.mark.parametrize("name,order", TOWERS, ids=["D4", "D5"])
def test_dth_root_order(name, order):
    F, J = getattr(towers, name), getattr(jtowers, name)
    assert F.dth_root == J.dth_root
    assert pow(F.dth_root, order, P) == 1
    assert pow(F.dth_root, 1, P) != 1
