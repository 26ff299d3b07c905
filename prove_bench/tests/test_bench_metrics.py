"""Each per-layer reader on a canned trace and canned timing scopes."""

import json
from pathlib import Path

import pytest

from prove_bench import run
from prove_bench.counts import peaks, stark

BENCH = Path(run.__file__).resolve().parent
CONFIG = json.loads((BENCH / "configs" / "fib_stark_fast.json").read_text())
SHAPE = stark.shape(1 << 20, 4, 2, 2, 2, CONFIG["fri"])


def ctx(**kw):
    base = dict(window_s=10.0, busy_s=1.5,
                kernel_s={"poseidon_kernel(long*, int)": 0.2,
                          "void hash_rows_kernel<1>(...)": 0.05,
                          "dft_kernel(...)": 0.02, "lde_kernel(...)": 0.03,
                          "elementwise_kernel": 1.2},
                scope_s={"quotient values + coefficients": 2.0,
                         "FRI opening proof": 4.0, "generate witness": 8.0,
                         "hash public inputs": 6.0, "compute quotient polys": 1.0,
                         "compute opening proofs (FRI)": 3.0},
                proofs=[{"pow_witness": 99}, {"pow_witness": 0}],
                work=SHAPE, config=CONFIG, traffic={"rows": 1 << 20})
    base.update(kw)
    return run.TraceContext(**base)


def read(name, c):
    return run.metric_reader(BENCH, name)(c)


def test_device_idle():
    for name in ("device_idle.stark", "device_idle.plonk"):
        assert read(name, ctx()) == pytest.approx(85.0)
        assert read(name, ctx(busy_s=None)) is None


@pytest.mark.parametrize("name,scope", [
    ("quotient_s.stark", "quotient values + coefficients"),
    ("fri_s.stark", "FRI opening proof"), ("witness_s.plonk", "generate witness"),
    ("pi_hash_s.plonk", "hash public inputs"),
    ("quotient_s.plonk", "compute quotient polys"),
    ("fri_s.plonk", "compute opening proofs (FRI)")])
def test_scope_means(name, scope):
    c = ctx()
    assert read(name, c) == pytest.approx(c.scope_s[scope] / 2)
    assert read(name, ctx(scope_s={})) is None


def test_poseidon_roofline():
    perms = 2 * stark.permutations(SHAPE) + 100 + 1
    want = 100 * perms * peaks.poseidon_muls() / peaks.INT32_MUL_PER_S / 0.25
    assert read("poseidon_roofline.stark", ctx()) == pytest.approx(want)
    assert read("poseidon_roofline.stark", ctx(kernel_s={})) is None
    assert read("poseidon_roofline.stark", ctx(work=None)) is None


def test_ntt_roofline():
    want = 100 * 2 * stark.ntt_bytes(SHAPE) / peaks.HBM_BYTES_PER_S / 0.05
    assert read("ntt_roofline.stark", ctx()) == pytest.approx(want)
    assert read("ntt_roofline.stark", ctx(kernel_s={"x": 1.0})) is None


def test_read_trace_busy_and_gaps():
    class Node:
        def __init__(self, name, start, end, children=()):
            self.name, self.start, self.end = name, start, end
            self.children = list(children)

        def duration(self):
            return self.end - self.start

    tree = Node("prove", 100.0, 110.0, [Node("generate witness", 100.0, 104.0)])
    # profiler clock = host clock - 50; marker at host 99.5
    events = [("marker", 49.5, 49.6), ("k1", 50.0 + 4.0, 50.0 + 6.0),
              ("k2", 50.0 + 5.0, 50.0 + 7.0), ("k1", 50.0 + 8.0, 50.0 + 9.0)]
    out = run.read_trace(events, 99.5, 100.0, 110.0, [tree])
    assert out["busy_s"] == pytest.approx(4.0)
    assert out["kernel_s"]["k1"] == pytest.approx(3.0)
    assert out["gaps"]["prove/generate witness"] == pytest.approx(4.0)
    assert out["gaps"]["prove"] == pytest.approx(2.0)


def test_a_gap_is_split_where_the_scopes_change():
    class Node:
        def __init__(self, name, start, end, children=()):
            self.name, self.start, self.end = name, start, end
            self.children = list(children)

    tree = Node("prove", 0.0, 8.0, [Node("generate witness", 0.0, 3.0),
                                     Node("hash public inputs", 3.0, 6.0)])
    events = [("marker", 10.0, 10.1), ("k", 16.0, 17.0)]    # host 6..7
    out = run.read_trace(events, 0.0 - 0.0, 0.0, 9.0, [tree])
    gaps = out["gaps"]
    assert gaps["prove/generate witness"] == pytest.approx(3.0)
    assert gaps["prove/hash public inputs"] == pytest.approx(3.0)
    assert gaps["prove"] == pytest.approx(1.0)
    assert gaps["(between proofs)"] == pytest.approx(1.0)
