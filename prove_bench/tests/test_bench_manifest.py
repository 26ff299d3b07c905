"""BENCHMARK.json against the contract's shape, every file it names
loaded by name, the configurations equal to the program's standard ones,
and a cell added as files alone (a fixture root in a temporary
directory)."""

import copy
import json
import re
import shutil
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
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_reports_one_prove_time_and_what_its_layers_move(cell):
    """A cell under two *_prove_s metrics would report one statement's time
    under the other's name; a per-layer metric has to move an end-to-end
    metric that its cell reports."""
    end_to_end = {m["name"]: m for m in MANIFEST["end_to_end"] if run.applies(m, cell)}
    assert sum(name.endswith("_prove_s") for name in end_to_end) == 1
    assert "setup_s" in end_to_end and "peak_mem_gib" in end_to_end
    per_layer = [m for m in MANIFEST["per_layer"] if run.applies(m, cell)]
    assert per_layer
    for m in per_layer:
        assert m["moves"] in end_to_end, (m["name"], m["moves"])


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


def test_a_later_cell_needs_no_edit_of_the_fixture(tmp_path):
    """A cell appended to BENCHMARK.json, with a metric of its own, builds
    the fixture root: a cell of a known statement maps onto that
    statement's stand-in, one of a statement without a stand-in drops out."""
    traffic = tmp_path / "traffic"
    shutil.copytree(ROOT / "prove_bench" / "traffic", traffic)
    (traffic / "wrap_x.json").write_text(json.dumps({"statement": "wrap_x"}))
    manifest = copy.deepcopy(MANIFEST)
    manifest["workloads"] += [
        {"name": "plonk_other", "config": "plonk_std_recursion", "traffic": "matmul_m64",
         "chips": 1, "why": "test"},
        {"name": "wrap_other", "config": "plonk_std_recursion", "traffic": "wrap_x",
         "chips": 1, "why": "test"}]
    manifest["per_layer"] += [
        {"name": "made_up.plonk", "unit": "s", "better": "lower", "source": "program_span",
         "layer": "Provers", "moves": "plonk_prove_s",
         "workloads": ["plonk_other", "wrap_other"]},
        {"name": "made_up.wrap", "unit": "s", "better": "lower", "source": "program_span",
         "layer": "Provers", "moves": "plonk_prove_s", "workloads": ["wrap_other"]}]
    root = make_root(tmp_path / "root", manifest, traffic)
    built = {m["name"]: m for m in json.loads((root / "BENCHMARK.json").read_text())["per_layer"]}
    assert built["made_up.plonk"]["workloads"] == ["plonk_m2"]
    assert built["made_up.wrap"]["workloads"] == []
    assert built["quotient_s.stark"]["workloads"] == ["stark_2p6"]


def test_a_cell_from_files_alone(tmp_path, capsys):
    """The fixture root adds two cells and a configuration each, as files
    and entries; every metric of BENCHMARK.json keeps its entry."""
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
                                          "quotient_s.plonk", "fri_s.plonk"}
    results = []
    capsys.readouterr()
    rc = run.main(["--workload", "plonk_m2", "--seed", str(2**31 + 13),
                   "--seconds", "0.1", "--trace", "0"], device="cpu", root=root,
                  results=results)
    assert rc == 0 and results[0]["correct"]
    assert set(results[0]["metrics"]) == {"plonk_prove_s", "peak_mem_gib", "setup_s"}
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    window = next(x for x in lines if x.get("line") == "window")
    assert len(window["proof_cpu_s"]) == len(window["proof_gc"]) == window["proofs"]
    assert all(s > 0 for s in window["proof_cpu_s"])
    assert all(len(g) == 3 and min(g) >= 0 for g in window["proof_gc"])
