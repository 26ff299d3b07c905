#!/usr/bin/env python3
"""The benchmark of plonky2_tpu_torch: seconds per proof over a timed window.

    python3 prove_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds BENCHMARK.json, prove_bench/
and the program (plonky2_tpu_torch/).  A cell of BENCHMARK.json names a
configuration (its file) and a traffic mix (prove_bench/traffic/<name>.json),
whose "statement" names the module under prove_bench/statements/ that sets
up the program and proves one input.  Per-layer metrics are readers under
prove_bench/metrics/<metric>.py.  So a cell, a statement or a per-layer
metric is added as files, without editing this one.

One run:
  1. set-up (setup_s, from process start to the first timed proof): the
     imports, the CUDA kernels (built once per checkout into the program's
     own build directory), the statement's set-up (inputs from --seed, the
     circuit built or read from its checkpoint) and one warm-up proof;
  2. the window: proofs back to back, each on the next input; none starts
     after --seconds, every one that started is finished and counted; the
     window runs from the start of the first proof to the end of the last,
     and a proof ends when the prove call and torch.cuda.synchronize() have
     returned;
  3. the judgement, once the window has closed and the program's state is
     freed: every proof's public inputs against the plain reference's
     values, and a sample of the proofs, drawn from the seed, through the
     plain reference verifier (prove_bench/reference/);
  4. the last line of standard output, one JSON object: with --trace 0 the
     cell's end-to-end metrics, with --trace 1 its per-layer metrics, read
     from the profiler's trace of the window and the program's timing
     scopes.

Earlier lines give every proof's seconds, its process CPU seconds and the
garbage collections during it by generation, the card (name, power limit,
SM clock and power sampled beside the window), each CUDA kernel's calls
and launches per proof, the parts of set-up, and the host's conditions.  The
numbers that decide `correct` are the last lines of standard error and the
last key of the result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names the process may not hold once the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "plonky2_tpu")
GIB = 1 << 30


def clock() -> float:
    return time.perf_counter()


def emit(kind: str, **fields) -> None:
    print(json.dumps({"line": kind, **fields}), flush=True)


# -- the manifest and the files it names -------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    seed: int
    bench_dir: Path
    cache_dir: Path

    def pinned_key(self) -> dict:
        """The verifying key pinned for this cell (keys/<cell>.json)."""
        return json.loads((self.bench_dir / "keys" / f"{self.name}.json").read_text())


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, bench_dir: Path, workload: str, seed: int) -> tuple:
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
    cell = Cell(workload, int(entry["chips"]), config, traffic, seed, bench_dir,
                bench_dir / "cache")
    return manifest, cell


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def statement_class(bench_dir: Path, name: str):
    return load_module(bench_dir / "statements" / f"{name}.py",
                       f"prove_bench_statement_{name}").Statement


def metric_reader(bench_dir: Path, name: str):
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "prove_bench_metric_" + name.replace(".", "_")).read


# -- what the per-layer readers get ---------------------------------------------

@dataclass
class TraceContext:
    window_s: float
    busy_s: float | None          # None: no device trace
    kernel_s: dict                # device seconds in the window by kernel name
    scope_s: dict                 # seconds in the window by timing-scope name
    proofs: list                  # per proof: the statement's facts
    work: dict | None             # the statement's shape for the work counts
    config: dict
    traffic: dict

    def kernel_seconds(self, functions) -> float:
        return sum(s for name, s in self.kernel_s.items()
                   if any(f in name for f in functions))

    def scope_seconds_per_proof(self, scope: str):
        if scope not in self.scope_s or not self.proofs:
            return None
        return self.scope_s[scope] / len(self.proofs)


def walk(tree, path=()):
    """(path, node) for every scope of a TimingTree."""
    path = path + (tree.name,)
    yield path, tree
    for child in tree.children:
        yield from walk(child, path)


def scope_seconds(trees: list) -> dict:
    out: dict = {}
    for tree in trees:
        for path, node in walk(tree):
            if len(path) > 1:
                out[node.name] = out.get(node.name, 0.0) + node.duration()
    return out


# -- the device trace ------------------------------------------------------------

def device_events(prof) -> list:
    """(name, start s, end s) of every device operation in the trace, on the
    profiler's clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
                for e in raw if e.device_type() == cuda]
    except AttributeError:
        return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in prof.events() if e.device_type == cuda]


def merge(intervals: list) -> list:
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def scope_segments(trees: list) -> list:
    """Host time cut at every scope's start and end: (start, end, path of
    the innermost scope open there), in order."""
    nodes = [(node.start, node.end, path) for tree in trees
             for path, node in walk(tree) if node.end is not None]
    cuts = sorted({t for start, end, _ in nodes for t in (start, end)})
    segments = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        paths = [p for start, end, p in nodes if start <= mid <= end]
        if paths:
            segments.append((a, b, "/".join(max(paths, key=len))))
    return segments


def label_gaps(gaps: list, segments: list) -> dict:
    """Seconds of the idle gaps (sorted, disjoint) by the innermost scope
    open at the time, each gap split where the scopes change."""
    out: dict = {}
    k = 0
    for a, b in gaps:
        covered = 0.0
        while k < len(segments) and segments[k][1] <= a:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < b:
            lo, hi = max(a, segments[j][0]), min(b, segments[j][1])
            if hi > lo:
                out[segments[j][2]] = out.get(segments[j][2], 0.0) + (hi - lo)
                covered += hi - lo
            j += 1
        if b - a - covered > 0:
            out["(between proofs)"] = out.get("(between proofs)", 0.0) + (b - a - covered)
    return out


def read_trace(events: list, t_mark: float, w0: float, w1: float, trees: list) -> dict:
    """Busy seconds, device seconds by kernel and the idle gaps by the
    scope the host was in, over the window [w0, w1] of host time.  The
    first event is the marker launched at host time t_mark."""
    if not events:
        return {"busy_s": 0.0, "kernel_s": {}, "gaps": {}}
    events = sorted(events, key=lambda e: e[1])
    offset = t_mark - events[0][1]          # profiler clock -> host clock
    inside = [(n, max(s + offset, w0), min(e + offset, w1)) for n, s, e in events[1:]]
    inside = [(n, s, e) for n, s, e in inside if e > s]
    kernel_s: dict = {}
    for n, s, e in inside:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s)
    busy = merge([(s, e) for _, s, e in inside])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return {"busy_s": sum(e - s for s, e in busy), "kernel_s": kernel_s,
            "gaps": label_gaps(gaps, scope_segments(trees))}


# -- the card and the host ----------------------------------------------------

def nvidia_smi(query: str) -> list:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.split(", ") for line in out.stdout.strip().splitlines()]


class SmiSampler:
    """nvidia-smi sampling the SM clock, power and temperature every 500 ms
    beside the window; stopped and waited for before the result."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.strip().splitlines():
            try:
                rows.append([float(v) for v in line.split(", ")[:3]])
            except ValueError:
                continue
        if not rows:
            return {}
        cols = list(zip(*rows))
        return {"samples": len(rows),
                "sm_clock_mhz": {"min": min(cols[0]), "max": max(cols[0]),
                                 "mean": sum(cols[0]) / len(rows)},
                "power_w": {"min": min(cols[1]), "max": max(cols[1]),
                            "mean": sum(cols[1]) / len(rows)},
                "temperature_c_max": max(cols[2])}


def host_conditions() -> dict:
    import platform

    import torch
    model = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key = line.split(":", 1)[0].strip().lower()
            if key in ("model name", "cpu model", "hardware", "cpu part") and not model:
                model = line.split(":", 1)[1].strip()
    except OSError:
        pass
    return {"cpu": model, "machine": platform.machine(),
            "visible_cores": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(), "loadavg": os.getloadavg()}


def cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def gc_collections() -> list:
    """The interpreter's garbage collections so far, by generation."""
    return [g["collections"] for g in gc.get_stats()]


def cuda_kernels() -> list:
    """Every CudaKernel (one C entry point each) of the program's modules."""
    from plonky2_tpu_torch.utils.cuda import CudaKernel
    found = []
    for name, mod in list(sys.modules.items()):
        if name.startswith("plonky2_tpu_torch.") and mod is not None:
            for value in list(vars(mod).values()):
                if isinstance(value, CudaKernel) and value not in found:
                    found.append(value)
    return found


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN_MODULES})


# -- one run --------------------------------------------------------------------

def main(argv=None, *, device=None, root=None, patch=None, program_config=None,
         results=None) -> int:
    """device: None runs on the card (and refuses without one); tests pass
    "cpu".  root: the directory holding BENCHMARK.json and prove_bench/.
    patch(statement): a test's hook that breaks the timed path.
    program_config: a configuration for the program in place of the
    cell's (the control, control.py); the judge keeps the cell's.
    results: a list the result is appended to."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root) if root else ROOT
    bench_dir = root / BENCH_DIR.name
    manifest, cell = load_cell(root, bench_dir, args.workload, args.seed)
    # every cache a run writes stays inside the checkout, at a fixed path
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cell.cache_dir / sub)
    on_card = device is None

    parts: dict = {}
    t = clock()
    import torch
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"run.py: the cell needs {cell.chips} CUDA device(s); "
                  f"cuda available={torch.cuda.is_available()}, "
                  f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    import plonky2_tpu_torch  # noqa: F401
    from plonky2_tpu_torch.utils.timing import TimingTree
    statement = statement_class(bench_dir, cell.traffic["statement"])(cell, device)
    parts["import_s"] = clock() - t
    t = clock()
    if on_card:
        from plonky2_tpu_torch.utils import cuda as cuda_build
        cuda_build.build_all()
    parts["kernel_load_s"] = clock() - t
    statement.setup(parts, clock, program_config)
    if patch is not None:
        patch(statement)
    t = clock()
    warm = TimingTree("prove", device)
    statement.prove(-1, warm)
    sync()
    parts["warmup_s"] = clock() - t
    setup_s = clock() - _T0
    kernels = cuda_kernels()
    card = {}
    if on_card:
        name_limit = nvidia_smi("name,power.limit,clocks.max.sm")
        card = {"name": torch.cuda.get_device_name(0),
                "power_limit_w": name_limit[0][1] if name_limit else None,
                "sm_clock_max_mhz": name_limit[0][2] if name_limit else None}
    emit("setup", setup_s=setup_s, parts=parts, card=card)

    # -- the window -------------------------------------------------------
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.reset()
    gc.collect()
    prof = None
    t_mark = None
    if args.trace and on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        sync()
        t_mark = clock()
        torch.ones(1, device=device).add_(1)      # the marker: first event
        sync()
    host = {"start": host_conditions()}
    smi = SmiSampler() if on_card else None
    cpu0 = cpu_seconds()
    proofs, seconds, trees, facts, failures = [], [], [], [], []
    proof_cpu, proof_gc = [], []
    w0 = clock()
    deadline = w0 + args.seconds
    i = 0
    while i == 0 or clock() < deadline:
        timing = TimingTree("prove", device)
        gc0 = gc_collections()
        cpu = cpu_seconds()
        t = clock()
        try:
            proof = statement.prove(i, timing)
            sync()
        except Exception:                         # a failed proof counts as failed
            traceback.print_exc()
            proof = None
            failures.append(i)
        timing.close()
        seconds.append(clock() - t)
        proof_cpu.append(cpu_seconds() - cpu)
        proof_gc.append([b - a for a, b in zip(gc0, gc_collections())])
        proofs.append(proof)
        trees.append(timing)
        if proof is not None:
            facts.append(statement.facts(proof))
        i += 1
    w1 = clock()
    window_s = w1 - w0
    cpu_s = cpu_seconds() - cpu0
    host["end"] = {"loadavg": os.getloadavg()}
    host["process_cpu_s"] = cpu_s
    host["window_wall_s"] = window_s
    card_window = smi.stop() if smi else {}
    trace = None
    if prof is not None:
        t = clock()
        prof.__exit__(None, None, None)
        stop_s = clock() - t
        t = clock()
        events = device_events(prof)
        trace = read_trace(events, t_mark, w0, w1, trees)
        emit("trace", profiler_stop_s=stop_s, read_s=clock() - t,
             device_events=len(events))
        prof = events = None
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    memory_peak = max(setup_peak, window_peak)
    n = len(proofs)
    emit("window", proofs=n, window_s=window_s, proof_s=seconds,
         proof_cpu_s=proof_cpu, proof_gc=proof_gc,
         kernels={k.symbol: {"calls_per_proof": k.calls / n,
                             "launches_per_proof": k.launches / n} for k in kernels},
         card=card_window, host=host,
         scopes_per_proof={k: v / n for k, v in scope_seconds(trees).items()})

    # -- the judgement, with the program's state freed ----------------------
    statement.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = clock()
    mismatched = [j for j, p in enumerate(proofs) if p is not None
                  and not statement.public_ok(j, p)]
    made = [j for j, p in enumerate(proofs) if p is not None]
    sample = sorted(random.Random(args.seed).sample(
        made, min(len(made), int(cell.traffic.get("verify_sample", 1)))))
    rejected = {}
    for j in sample:
        try:
            statement.verify(proofs[j])
        except Exception as exc:                  # any failure rejects the proof
            rejected[j] = f"{type(exc).__name__}: {exc}"
    judge_s = clock() - t
    emit("judge", judge_s=judge_s, public_checked=len(made), verified=sample,
         rejected=rejected, mismatched=mismatched, failed=failures)
    checks = {"rejected": {"value": len(rejected), "limit": 0},
              "public_mismatch": {"value": len(mismatched), "limit": 0},
              "failed": {"value": len(failures), "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(sample)

    # -- the result ---------------------------------------------------------
    metrics = {}
    if args.trace:
        ctx = TraceContext(window_s, trace["busy_s"] if trace else None,
                           trace["kernel_s"] if trace else {}, scope_seconds(trees),
                           facts, statement.work(), cell.config, cell.traffic)
        for m in manifest["per_layer"]:
            if applies(m, cell.name):
                value = metric_reader(bench_dir, m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, "peak_mem_gib": window_peak / GIB}
        for m in manifest["end_to_end"]:
            if not applies(m, cell.name):
                continue
            if m["name"].endswith("_prove_s"):
                value = window_s / n
            else:
                value = values[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": n,
              "failed": len(failures) + len(set(mismatched) | set(rejected)),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else str(device.type),
                         "kind": card.get("name", str(device)),
                         "count": cell.chips, "memory_peak_bytes": memory_peak}}
    if args.trace and trace is not None:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = window_s
        top = sorted(trace["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(trace["gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:120], v] for k, v in top],
                               "idle_gaps": [[k[:120], v] for k, v in gaps]}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"run.py: the process holds {', '.join(found)}: the benchmark "
              "may load neither JAX nor the JAX package", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"check verified: {len(sample)} of {n} proofs (limit: at least 1)",
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    if results is not None:
        results.append(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
