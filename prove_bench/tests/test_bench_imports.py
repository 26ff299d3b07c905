"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the plain reference imports nothing of
the program."""

import ast
import subprocess
import sys
from pathlib import Path

from prove_bench import run

BENCH = Path(run.__file__).resolve().parent


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "plonky2_tpu_torch_fake", object())
    assert "plonky2_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "plonky2_tpu.fake", object())
    assert "plonky2_tpu" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    """Import every module the harness runs in a fresh process."""
    code = """
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from prove_bench import run, control
bench = Path(run.__file__).parent
for p in sorted((bench / "statements").glob("*.py")):
    run.load_module(p, "s_" + p.stem)
for p in sorted((bench / "metrics").glob("*.py")):
    run.load_module(p, "m_" + p.stem.replace(".", "_"))
import plonky2_tpu_torch.stark.prover, plonky2_tpu_torch.plonk.prover
import plonky2_tpu_torch.models.matrix_mul, plonky2_tpu_torch.utils.serialization
print(",".join(run.forbidden_modules()))
""".format(root=str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    allowed = {"numpy", "re", "dataclasses", "__future__"}
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module.split(".")[0]]
            else:
                continue
            assert set(names) <= allowed, (path.name, names)
