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
# parameters (rate 3, cap height 4): its verifying key, as the JAX
# package's build_matrix_mul_circuit(2) gives it
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


# the fixture cell that stands in for the real cells of each statement
STAND_IN = {"fib": "stark_2p6", "matmul": "plonk_m2"}


def tiny(config: dict, queries: int, pow_bits: int) -> dict:
    out = copy.deepcopy(config)
    out["fri"]["num_query_rounds"] = queries
    out["fri"]["proof_of_work_bits"] = pow_bits
    return out


def stand_ins(manifest: dict, cells: list, traffic_dir: Path) -> list:
    """The fixture cells that stand in for `cells`, found by the statement
    of each one's traffic mix; a statement without a stand-in has none."""
    traffic = {w["name"]: w["traffic"] for w in manifest["workloads"]}
    statements = {json.loads((traffic_dir / f"{traffic[c]}.json").read_text())["statement"]
                  for c in cells}
    return sorted({STAND_IN[s] for s in statements if s in STAND_IN})


def make_root(tmp: Path, manifest: dict | None = None,
              traffic_dir: Path = BENCH / "traffic") -> Path:
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
    manifest = copy.deepcopy(manifest or json.loads((REPO / "BENCHMARK.json").read_text()))
    # every metric keeps its entry; its cells become their stand-ins
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = stand_ins(manifest, m["workloads"], traffic_dir)
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
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return tmp
