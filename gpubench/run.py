"""Run one cell of the benchmark of ``models_tpu_torch`` on this machine's card.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; last, ``checks``: each number the correctness check compared
beside its limit), and the same numbers as the last lines of standard error.
Exits non-zero, printing no result, where the card is missing, the cell asks
for more cards than there are, the program cannot be imported, or a module
of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the program's kernels build into build/ of the checkout; every other cache
# a library may keep goes there too, at a fixed path
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness  # noqa: E402

T_START = harness.process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed is a whole number from 0")

    import torch

    cell = harness.find_cell(args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    run = harness.RunContext(cell, args.seed, args.seconds, bool(args.trace), T_START)
    outcome = cell.entry().run(run)

    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = harness.result_line(cell, outcome, run.trace, device)
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
