"""The control of a cell's check: the plain reference put in the program's
place, one precision below the configuration's (TF32 for float32), read by
the same gaps that decide a run's ``correct``. A sound check finds it not
correct. Not part of a benchmark run.

    python gpubench/control.py --workload tt_train --seeds 11 12 13 [--kind tf32]

``--kind`` names another control an entry offers (``CONTROLS``), such as a
training cell's ``half_batch`` fault (each step on half its batch). Prints
one JSON line a seed: the cell, the seed, the control, each gap beside the
cell's limit, and whether the control came out correct (it should not).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, nargs="+")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kind", default="tf32")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gpubench: the control runs on a CUDA card; there is none", file=sys.stderr)
        return 2
    for name in args.workload:
        cell = harness.find_cell(name)
        limits = cell.spec.get("limits", {})
        if args.kind not in cell.entry().CONTROLS:
            continue
        for seed in args.seeds:
            gaps = cell.entry().control(cell, seed, "cuda", args.kind)
            checks = {n: (v, limits.get(n)) for n, v in gaps.items()}
            print(json.dumps({"workload": name, "seed": seed, "kind": args.kind,
                              "checks": {n: {"value": v, "limit": lim}
                                         for n, (v, lim) in checks.items()},
                              "correct": harness.correct_of(checks)}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
