"""A/B host times of the training step, one step at a time, of the
two-tower model, the DLRM and the MMOE on one NVIDIA card, for this
checkout and another one, in turns in one call; with ``--what predict``,
of the top-k encoder's ``predict``.

    python3 ab_steps.py --parent DIR [--reps N] [--what steps|predict]

``DIR`` is another checkout's root (e.g. one unpacked by
``git archive <commit> | tar -x -C build/parent``). Each turn is a process
of its own that imports ``models_tpu_torch`` and ``chip_smoke`` from one
checkout, in the order parent, head, head, parent. A turn builds each model
as ``chip_smoke.py``'s phases do (``build_model``: the movielens-25m
two-tower at batch 8192, adagrad; ``dlrm_model``: the DLRM on criteo-small
at batch 8192, adagrad; ``MMOE_KW`` on the full Ali-CCP schema at batch
2048, adam with ``mt_compile``), fits two warm-up steps, and times ``reps``
calls of ``train_step`` on the host clock, each ending in a synchronise
(``chip_smoke.host_ms``). The one-at-a-time routes are host-bound, so these
times move with the host work a step does (block calls, argument checks).

``--what predict`` times instead the movielens-25m two-tower's top-k
encoder over the 56,680-item catalog (untrained, ``build_model``), fp32,
bf16 and int8 indexes, ``predict`` of 256 rows (K5, the binned route) and
4096 rows (K6, the streaming route) from host arrays, each call ending in
a synchronise. Where a tree registers K5 and K6 as ``torch.library`` ops,
its turn also times one call of each through the op
(``torch.ops.models_tpu_torch``) against the same call of its CUDA
implementation directly, on the fp32 index at those shapes (one call a
synchronise, ``reps`` calls each, alternating): the dispatch's own cost.

Prints the card's name and power limit, and one JSON line per model or
request: ``{"what": ..., "ms": {"parent": [turn 1, turn 2], "head":
[...]}}``, each entry [median, min, max] ms; with ``--what predict`` also
``{"what": "dispatch ...", "ms": {"head": [...]}}`` lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MODELS = ("two_tower", "dlrm", "mmoe")
REQUESTS = tuple(f"{tag}_B{b}" for tag in ("fp32", "bf16", "int8") for b in (256, 4096))


def _setup(tree: str):
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as C
    import models_tpu_torch as mt

    assert Path(mt.__file__).resolve().is_relative_to(Path(tree).resolve()), mt.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return C, mt, torch.device("cuda", 0)


def predict_worker(tree: str, reps: int) -> None:
    import numpy as np
    import torch

    C, mt, dev = _setup(tree)
    from models_tpu_torch.ops import topk as T

    model, catalog, queries = C.build_model(dev)
    out = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                       ("int8", torch.int8)):
        enc = model.to_top_k_encoder(catalog, k=C.K, candidate_dtype=dtype, batch_size=8192,
                                     device=dev)
        for b in (256, 4096):
            ds = queries.take(b)
            out[f"{tag}_B{b}"] = C.host_ms(lambda: enc.predict(ds, batch_size=b, device=dev),
                                           reps=reps)
        if tag == "fp32" and hasattr(torch.ops.models_tpu_torch, "binned_rescore"):
            index = enc.blocks[-1].topk_layer
            x = mt.core.types.to_device_batch(next(iter(mt.Loader(queries, 4096)))[0], dev)
            q = enc.blocks[0](x).detach().contiguous()
            n = index.n_valid
            idx = T.select_bins(q[:256], index.candidates, C.K, n_valid=n)
            ops = torch.ops.models_tpu_torch
            calls = {
                "binned_rescore": (
                    lambda: ops.binned_rescore(q[:256], index.candidates, idx, 64),
                    lambda: T._binned_rescore_cuda(q[:256], index.candidates, idx, 64)),
                "streaming_topk": (
                    lambda: ops.streaming_topk(q, index.candidates, C.K, index.ids, n, None),
                    lambda: T._streaming_topk_cuda(q, index.candidates, C.K, index.ids, n,
                                                   None)),
            }
            for name, (via_op, direct) in calls.items():
                times = {"op": [], "direct": []}
                for fn in (via_op, direct):
                    fn()
                torch.cuda.synchronize()
                for _ in range(reps):
                    for form, fn in (("op", via_op), ("direct", direct)):
                        t = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        times[form].append((time.perf_counter() - t) * 1e3)
                for form, ts in times.items():
                    out[f"dispatch {name} {form}"] = [float(np.median(ts)), min(ts), max(ts)]
        del enc
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


def worker(tree: str, reps: int) -> None:
    import numpy as np
    import torch

    C, mt, dev = _setup(tree)
    from models_tpu_torch.core.types import to_device_batch, to_device_targets

    def build(name):
        if name == "two_tower":
            model = C.build_model(dev)[0]
            data = mt.generate_data("movielens-25m", num_rows=8 * C.TRAIN_BATCH, seed=C.SEED + 3)
            model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
            return model, data, C.TRAIN_BATCH
        if name == "dlrm":
            data = mt.generate_data("criteo-small", num_rows=8 * C.TRAIN_BATCH, seed=C.SEED + 7)
            model = C.dlrm_model(dev, data.schema)
            model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
            return model, data, C.TRAIN_BATCH
        data = mt.generate_data("aliccp", num_rows=16 * C.MT_BATCH, seed=C.SEED + 19)
        model = mt.MMOEModel(data.schema, seed=C.SEED, device=dev, **C.MMOE_KW)
        C.mt_compile(model)
        return model, data, C.MT_BATCH

    out = {}
    for name in MODELS:
        model, data, batch = build(name)
        model.fit(data.take(2 * batch), batch_size=batch, shuffle=False, device=dev)
        loss_fns = model._resolve_task_losses()
        batches = list(mt.Loader(data, batch, drop_last=True))
        it = iter(batches * (reps // len(batches) + 2))

        def step():
            x, y = next(it)
            model.train_step(to_device_batch(x, dev), to_device_targets(y, dev), loss_fns)

        out[name] = C.host_ms(step, reps=reps)
        assert all(np.isfinite(v) for v in out[name])
        del model
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--reps", type=int, default=41)
    ap.add_argument("--what", choices=("steps", "predict"), default="steps")
    ap.add_argument("--worker")
    args = ap.parse_args()
    if args.worker:
        (worker if args.what == "steps" else predict_worker)(args.worker, args.reps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_steps: no CUDA device", file=sys.stderr)
        return 1
    if not args.parent:
        ap.error("--parent DIR is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"parent": str(Path(args.parent).resolve()), "head": str(ROOT)}
    ms = {}
    for form in ("parent", "head", "head", "parent"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(ROOT / "ab_steps.py"), "--worker",
                               trees[form], "--reps", str(args.reps), "--what", args.what],
                              cwd=trees[form], env=env, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        for name, t in json.loads(lines[-1][len("RESULT "):]).items():
            ms.setdefault(name, {}).setdefault(form, []).append(t)
    for name, by_tree in ms.items():
        what = (f"{name} train_step one at a time" if name in MODELS else
                name if name.startswith("dispatch") else f"predict {name}")
        print(json.dumps({"what": what, "ms": by_tree}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
