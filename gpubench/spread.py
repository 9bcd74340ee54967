"""Run cells of the benchmark several times, each run a process of its own,
and report each metric's spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the median.

    python gpubench/spread.py --workload tt_train --seeds 11 12 13 --seconds 10 \
        [--trace 0] [--out runs.jsonl]

Each run's result line (or its failure) is appended to ``--out`` with its
cell, seed and exit code; the spreads are printed as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, nargs="+")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--out", type=Path)
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args(argv)
    summary = {}
    for cell in args.workload:
        values = {}
        for seed in args.seeds:
            cmd = [sys.executable, str(RUN), "--workload", cell, "--seed", str(seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            wall = time.perf_counter() - t
            lines = proc.stdout.strip().splitlines()
            result = None
            if proc.returncode == 0 and lines:
                result = json.loads(lines[-1])
                for name, m in result["metrics"].items():
                    values.setdefault(name, []).append(m["value"])
            record = {"workload": cell, "seed": seed, "rc": proc.returncode, "wall_s": wall,
                      "result": result, "stderr_tail": proc.stderr[-3000:]}
            print(json.dumps({k: record[k] for k in ("workload", "seed", "rc", "wall_s")}
                             | {"correct": result and result["correct"],
                                "metrics": result and {n: m["value"] for n, m in
                                                       result["metrics"].items()},
                                "checks": result and result.get("checks")}), flush=True)
            if result is None:
                print(proc.stderr[-3000:], file=sys.stderr, flush=True)
            if args.out is not None:
                with open(args.out, "a") as f:
                    f.write(json.dumps(record) + "\n")
        summary[cell] = {n: {"median": statistics.median(v), "spread": spread(v), "n": len(v)}
                         for n, v in values.items()}
    print(json.dumps({"spreads": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
