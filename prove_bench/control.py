#!/usr/bin/env python3
"""The control of `correct`: the program run with one guarantee of the
cell's configuration broken, judged against the cell's configuration.

    python3 prove_bench/control.py --workload <cell> --seeds 11,12,13 --seconds <s>

The configurations state no precision; the step that would tempt a
faster prover is to spend less on soundness.  The control proves with one
FRI query round fewer than the configuration states (83 of 84, 27 of 28),
which makes every proof cheaper and 1 bit (or so) less sound, and runs
each seed through run.py's window and judgement in one process.  The
judge has to reject its proofs: each seed's line gives the numbers that
decide `correct` beside their limits.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from prove_bench import run  # noqa: E402


def weakened(config: dict) -> dict:
    out = copy.deepcopy(config)
    out["fri"]["num_query_rounds"] -= 1
    return out


def main(argv=None, *, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(root) if root else run.ROOT
    _, cell = run.load_cell(root, root / run.BENCH_DIR.name, args.workload, 0)
    control = weakened(cell.config)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        results: list = []
        rc = run.main(["--workload", args.workload, "--seed", str(seed),
                       "--seconds", str(args.seconds), "--trace", "0"],
                      device=device, root=root, program_config=control,
                      results=results)
        if rc != 0 or not results:
            return rc or 1
        checks = results[0]["checks"]
        readings.append({"seed": seed, "correct": results[0]["correct"],
                         "attempted": results[0]["attempted"],
                         **{k: v["value"] for k, v in checks.items()}})
    print(json.dumps({"control": args.workload,
                      "num_query_rounds": control["fri"]["num_query_rounds"],
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
