"""BENCHMARK.json against the contract's shape, every file it names
loaded by name, the configurations equal to the program's standard ones,
and a cell added as files alone (a fixture root in a temporary
directory)."""

import json
import re
from pathlib import Path

import pytest

from prove_bench import run
from prove_bench.tests.fixtures import make_root

ROOT = Path(run.__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["prove_bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in layers
        for w in m["workloads"]:
            assert run.applies(layers[m["moves"]], w)
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_loads(cell):
    _, c = run.load_cell(ROOT, ROOT / "prove_bench", cell, 2**31 + 7)
    assert c.chips == 1
    run.statement_class(c.bench_dir, c.traffic["statement"])
    assert c.config["reduced"] == []
    if c.traffic["statement"] == "matmul":
        assert c.pinned_key()["num_public_inputs"] == 3 * c.traffic["m"] ** 2


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_every_metric_reader_loads(metric):
    assert callable(run.metric_reader(ROOT / "prove_bench", metric))


def test_configs_are_the_programs_standard_ones():
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.stark.config import StarkConfig
    from prove_bench.statements import fib, matmul
    configs = {p.stem: json.loads(p.read_text())
               for p in (ROOT / "prove_bench" / "configs").glob("*.json")}
    st = fib.Statement.__new__(fib.Statement)
    assert st.program_config(configs["fib_stark_fast"]) == StarkConfig.standard_fast_config()
    st = matmul.Statement.__new__(matmul.Statement)
    assert (st.program_config(configs["plonk_std_recursion"])
            == CircuitConfig.standard_recursion_config())


def test_a_cell_from_files_alone(tmp_path):
    """The fixture root adds two cells, a configuration each, the plonk
    cell's end-to-end and per-layer metrics, all as files and entries."""
    root = make_root(tmp_path)
    manifest, cell = run.load_cell(root, root / "prove_bench", "stark_2p6", 5)
    assert cell.traffic["rows"] == 64 and cell.config["fri"]["num_query_rounds"] == 6
    results = []
    rc = run.main(["--workload", "stark_2p6", "--seed", str(2**31 + 11),
                   "--seconds", "0.1", "--trace", "0"], device="cpu", root=root,
                  results=results)
    assert rc == 0 and results[0]["correct"]
    assert set(results[0]["metrics"]) == {"stark_prove_s", "peak_mem_gib", "setup_s"}
    assert list(results[0])[-1] == "checks"
    results = []
    rc = run.main(["--workload", "plonk_m2", "--seed", str(2**31 + 12),
                   "--seconds", "0.1", "--trace", "1"], device="cpu", root=root,
                  results=results)
    assert rc == 0 and results[0]["correct"]
    assert set(results[0]["metrics"]) == {"witness_s.plonk", "pi_hash_s.plonk",
                                          "quotient_s.plonk"}
