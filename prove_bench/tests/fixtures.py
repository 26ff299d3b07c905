"""A benchmark root in a temporary directory with tiny cells of its own:
BENCHMARK.json, configurations, traffic mixes and a pinned key, beside
copies of the real statements and metric readers.  Loading a cell from it
shows that a new cell is files alone."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "prove_bench"

# the m = 2 matmul circuit under standard_recursion_config's commitment
# parameters (rate 3, cap height 4): its verifying key
MATMUL_2_KEY = {
    "gates": ["NoopGate", "ConstantGate { num_consts: 2 }", "PublicInputGate",
              "ArithmeticGate { num_ops: 20 }",
              "PoseidonGate(PhantomData<plonky2_field::goldilocks_field::GoldilocksField>)<WIDTH=12>"],
    "selector_indices": [0, 0, 0, 0, 1],
    "selector_groups": [[0, 4], [4, 5]],
    "num_constants": 4,
    "num_public_inputs": 12,
    "degree_bits": 3,
    "circuit_digest": [2404256257049340778, 9675750848251696557,
                       12451093620349341003, 9310108758222760445],
}


def tiny(config: dict, queries: int, pow_bits: int) -> dict:
    out = copy.deepcopy(config)
    out["fri"]["num_query_rounds"] = queries
    out["fri"]["proof_of_work_bits"] = pow_bits
    return out


def make_root(tmp: Path) -> Path:
    bench = tmp / "prove_bench"
    for sub in ("statements", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    for sub in ("configs", "traffic", "keys"):
        (bench / sub).mkdir(parents=True)
    fib = json.loads((BENCH / "configs" / "fib_stark_fast.json").read_text())
    plonk = json.loads((BENCH / "configs" / "plonk_std_recursion.json").read_text())
    (bench / "configs" / "fib_tiny.json").write_text(json.dumps(tiny(fib, 6, 2)))
    (bench / "configs" / "plonk_tiny.json").write_text(json.dumps(tiny(plonk, 4, 2)))
    (bench / "traffic" / "fib_2p6.json").write_text(json.dumps(
        {"statement": "fib", "rows": 64, "pool": 3, "verify_sample": 2}))
    (bench / "traffic" / "matmul_m2.json").write_text(json.dumps(
        {"statement": "matmul", "m": 2, "verify_sample": 2}))
    (bench / "keys" / "plonk_m2.json").write_text(json.dumps(MATMUL_2_KEY))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"] = [
        {"name": "fib_tiny", "source": "https://example.org/fib",
         "file": "prove_bench/configs/fib_tiny.json", "reduced": [], "why": "test"},
        {"name": "plonk_tiny", "source": "https://example.org/plonk",
         "file": "prove_bench/configs/plonk_tiny.json", "reduced": [], "why": "test"}]
    manifest["workloads"] = [
        {"name": "stark_2p6", "config": "fib_tiny", "traffic": "fib_2p6", "chips": 1,
         "why": "test"},
        {"name": "plonk_m2", "config": "plonk_tiny", "traffic": "matmul_m2", "chips": 1,
         "why": "test"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["stark_2p6"]
    # the plonk cell's metrics, added as entries: their readers are files
    manifest["end_to_end"].append(
        {"name": "plonk_prove_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["plonk_m2"]})
    for name, layer in (("device_idle.plonk", "Device"),
                        ("witness_s.plonk", "Circuit build and witness"),
                        ("pi_hash_s.plonk", "Hash / Merkle"),
                        ("quotient_s.plonk", "Provers")):
        manifest["per_layer"].append(
            {"name": name, "unit": "%" if "idle" in name else "s", "better": "lower",
             "source": "device_trace" if "idle" in name else "program_span",
             "layer": layer, "moves": "plonk_prove_s", "workloads": ["plonk_m2"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return tmp
