"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the port's CUDA kernels from ``models_tpu_torch/csrc`` (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, fp32 and bf16, with padding and planted
   ties, and the streaming kernel also at k=256 and k=512 and with few query
   rows over a 1M-row catalog (more than 32 catalog splits per row);
4. serves the two-tower model end to end at the bench's full width
   (movielens-25m schema, query_tower=(256, 128), embedding_dim=128, seeded
   random weights) over the whole 56,680-item catalog, fp32 and bf16
   indexes: a 256-row request (the binned route, phase B in the rescore
   kernel) and a 4096-row request (the streaming kernel), each held against
   the plain route; the launch counts of this phase show which kernels it ran;
5. prints one JSON line with each kernel's launches, error against its plain
   version, its time, the plain version's, the least time the card could take
   and one PyTorch call's, then the card line and ``{"ok": true, ...}`` last.
   Request times are host-clock medians with their range, [median, min, max].

Any failed check raises, and the script exits non-zero. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
REL_TOL = 2e-6  # fp32 sums of 128 products taken in another order
SEED = 0
CATALOG = 56_680  # movieIds 0..56679
K = 10


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 21) -> list:
    """Wall times of ``reps`` calls of ``fn``, each ending in a synchronise (a
    whole request): [median, min, max] in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return [float(np.median(times)), min(times), max(times)]


def tol_for(ref) -> float:
    """REL_TOL of the largest |score| of the reference, and at least REL_TOL."""
    ref = torch.as_tensor(ref).float()
    real = ref[ref > torch.finfo(torch.float32).min]
    return REL_TOL * max(1.0, float(real.abs().max()) if real.numel() else 0.0)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_topk(name, got, want, positions=None):
    """Kernel result vs plain result: scores within ``tol_for``, ids equal outside
    near-ties; with ``positions`` (ids were positions), equal scores must come
    in ascending position."""
    from models_tpu_torch.ops.topk import ids_agree, max_abs_err

    torch.cuda.synchronize()
    (s, i), (ps, pi) = [(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()) for a, b in (got, want)]
    err, tol = max_abs_err(s, ps), tol_for(ps)
    require(torch.isfinite(s).all().item(), f"{name}: non-finite scores")
    require(ids_agree(s, i, ps, pi, tol),
            f"{name}: disagrees with the plain version (max |d score| {err})")
    if positions:
        same = s[:, 1:] == s[:, :-1]
        require(bool((i[:, 1:][same] > i[:, :-1][same]).all()),
                f"{name}: equal scores not in ascending position")
    exact = float((i == pi).float().mean())
    print(f"  {name}: max|d score| {err:.3g} (tol {tol:.3g}), ids equal {exact:.6f}",
          flush=True)
    return err


# ---------------------------------------------------------------------------


def phase_kernels(dev, gen):
    """Each kernel against its plain version at the serving shapes."""
    from models_tpu_torch.ops import topk as T

    errs = {"streaming_topk": 0.0, "binned_rescore": 0.0}
    # (B, C, n_valid, k): the two serving sizes; a long list (k=256, several
    # 32-entry chunks shifted per insert) and the largest the kernel holds;
    # few rows over 1M candidates, so that each row merges over 32 splits
    cases = ((4096, 56_704, CATALOG, K), (2048, 1_000_000, None, K),
             (64, 1_000_000, 999_937, 256), (16, 56_704, CATALOG, 512),
             (8, 1_000_000, None, K))
    for B, C, n_valid, k in cases:
        q = torch.randn(B, 128, device=dev, generator=gen)
        c = torch.randn(C, 128, device=dev, generator=gen)
        for dup in (C // 3, C // 2, (n_valid or C) - 1):  # planted ties
            c[dup] = c[7]
        for dtype in (torch.float32, torch.bfloat16):
            cd = c.to(dtype)
            got = T.streaming_topk(q, cd, k, n_valid=n_valid)
            want = T.streaming_topk_plain(q, cd, k, n_valid=n_valid)
            err = check_topk(f"streaming_topk B={B} C={C} n_valid={n_valid} k={k} {dtype}",
                             got, want, positions=True)
            errs["streaming_topk"] = max(errs["streaming_topk"], err)
            # a planted duplicate ranks: query with row 7 itself
            s, pos = T.streaming_topk(c[7:8].float().contiguous(), cd, 4, n_valid=n_valid)
            require(pos[0, :4].tolist() == sorted(pos[0, :4].tolist())
                    and pos[0, 0].item() == 7, f"planted ties resolved as {pos.tolist()}")
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(256, 128, device=dev, generator=gen)
        c = torch.randn(886 * 64, 128, device=dev, generator=gen).to(dtype)
        idx = torch.randint(0, 886, (256, 12), device=dev, generator=gen, dtype=torch.int32)
        got = T.binned_rescore(q, c, idx, 64)
        want = T.binned_rescore_plain(q, c, idx, 64)
        torch.cuda.synchronize()
        err = T.max_abs_err(got, want)
        require(err <= tol_for(want), f"binned_rescore {dtype}: max|d| {err}")
        print(f"  binned_rescore B=256 kb=12 bs=64 D=128 {dtype}: max|d| {err:.3g}", flush=True)
        errs["binned_rescore"] = max(errs["binned_rescore"], err)
    return errs


def build_model(dev):
    import models_tpu_torch as mt

    schema = mt.generate_data("movielens-25m", num_rows=1).schema
    model = mt.TwoTowerModel(schema, query_tower=(256, 128), embedding_dim=128,
                             seed=SEED, device=dev)
    cat = mt.generate_data("movielens-25m", num_rows=CATALOG, seed=SEED + 1).to_numpy_dict()
    cat["movieId"] = np.arange(CATALOG, dtype=np.int32)  # every item once
    catalog = mt.Dataset(cat, schema=schema)
    queries = mt.generate_data("movielens-25m", num_rows=4096, seed=SEED + 2)
    return model, catalog, queries


def phase_serving(dev, model, catalog, queries):
    """The main path: index, then serve requests of 256 rows (the binned
    route, phase B in the rescore kernel) and 4096 rows (the streaming kernel)."""
    from models_tpu_torch.ops import topk as T

    results, timing = {}, {}
    q_ds = {256: queries.take(256), 4096: queries}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        t = time.perf_counter()
        enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, candidate_dtype=dtype,
                                     device=dev)
        torch.cuda.synchronize()
        timing[f"index_{tag}_ms"] = (time.perf_counter() - t) * 1e3
        bf = enc.blocks[-1].topk_layer
        require(bf.candidates.shape == (56_704, 128) and bf.n_valid == CATALOG,
                f"index shape {tuple(bf.candidates.shape)}, n_valid {bf.n_valid}")
        for B in (256, 4096):
            before = T.streaming_topk.launches, T.binned_rescore.launches
            out = enc.predict(q_ds[B], batch_size=B, device=dev)
            ran_k6 = T.streaming_topk.launches > before[0]
            ran_k5 = T.binned_rescore.launches > before[1]
            require(ran_k6 == (B == 4096), f"B={B}: streaming kernel ran: {ran_k6}")
            require(ran_k5 == (B == 256), f"B={B}: rescore kernel ran: {ran_k5}")
            require(out["scores"].shape == (B, K) and out["ids"].shape == (B, K),
                    f"predict shapes {out['scores'].shape}")
            require(np.isfinite(out["scores"]).all(), "non-finite scores")
            require(((out["ids"] >= 0) & (out["ids"] < CATALOG)).all(), "ids out of range")
            results[(tag, B)] = (enc, out)
    return results, timing


def check_serving(dev, model, queries, results):
    """Each served result against the plain route on the card, and the first
    rows against the same model run on the CPU."""
    import copy

    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T

    for (tag, B), (bf_enc, out) in results.items():
        x, _ = next(iter(Loader(queries.take(B), B)))
        with torch.no_grad():
            qv = model.query_encoder(to_device_batch(x, dev))
        got = (torch.as_tensor(out["scores"]), torch.as_tensor(out["ids"]))
        bf = bf_enc.blocks[-1].topk_layer
        want = T.streaming_topk_plain(qv, bf.candidates, K, ids=bf.ids, n_valid=bf.n_valid)
        check_topk(f"serve {tag} B={B} vs plain", got, want)
    # a small input through the same model on the CPU
    enc = results[("fp32", 256)][0]
    small = queries.take(16)
    ref = copy.deepcopy(enc).to("cpu").predict(small, batch_size=16, device="cpu")
    out = enc.predict(small, batch_size=16, device=dev)
    require(T.ids_agree(out["scores"], out["ids"], ref["scores"], ref["ids"],
                        tol_for(ref["scores"])),
            "card and CPU disagree on 16 requests")
    print("  serve fp32 B=16 card vs CPU: agree", flush=True)


def serving_breakdown(dev, model, queries, results):
    """Where a request's time goes: host batch assembly and copy to the card
    (host clock), the query tower and the top-k layer (device time)."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader

    out = {}
    for B in (256, 4096):
        ds = queries.take(B)
        out[f"host_batch_B{B}_ms"] = host_ms(
            lambda: to_device_batch(next(iter(Loader(ds, B)))[0], dev))
        xb = to_device_batch(next(iter(Loader(ds, B)))[0], dev)
        with torch.no_grad():
            out[f"tower_B{B}_ms"] = cuda_ms(lambda: model.query_encoder(xb))
            qv = model.query_encoder(xb)
            for tag in ("fp32", "bf16"):
                bf = results[(tag, B)][0].blocks[-1].topk_layer
                out[f"topk_{tag}_B{B}_ms"] = cuda_ms(lambda: bf(qv))
    return out


def _row(name, source, replaces, launches, err, ms, plain, lib, flops, nbytes):
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": lib,
    }


def phase_measure(dev, model, queries, results, launches, errs):
    """Each kernel timed on the inputs the serving path gave it (the query
    embeddings of the 4096- and 256-row requests, the index, the bins phase A
    selects), beside its plain version and one PyTorch call. Calls run back to
    back, so a catalog that fits the 50 MB L2 stays there, as it does between
    requests. Returns the kernels line (fp32 index) and the bf16 times."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T

    x, _ = next(iter(Loader(queries, 4096)))
    with torch.no_grad():
        q4096 = model.query_encoder(to_device_batch(x, dev)).contiguous()
    q256 = q4096[:256].contiguous()
    rows, bf16 = [], {}
    for tag in ("fp32", "bf16"):
        bf = results[(tag, 4096)][0].blocks[-1].topk_layer
        n, D = bf.n_valid, bf.candidates.shape[1]
        item = bf.candidates.element_size()
        cand, ids = bf.candidates[:n], bf.ids[:n]  # the streaming route drops the padding
        B = q4096.shape[0]
        ms = cuda_ms(lambda: T.streaming_topk(q4096, cand, K, ids=ids))
        plain = cuda_ms(lambda: T.streaming_topk_plain(q4096, cand, K, ids=ids), reps=3)
        lib = cuda_ms(lambda: torch.topk(q4096 @ cand.float().T, K))
        k6 = _row("streaming_topk", "models_tpu_torch/csrc/streaming_topk.cu",
                  "models_tpu/ops/topk.py:102", launches["streaming_topk"],
                  errs["streaming_topk"], ms, plain, lib, 2 * B * n * D,
                  B * D * 4 + n * D * item + n * 4 + B * K * 8)
        full = bf.candidates  # 886 full bins, the padding in the last
        bs = 64
        idx = T.select_bins(q256, full, K, n_valid=n)
        B, kb = idx.shape
        c3 = full.view(-1, bs, D)
        got = T.binned_rescore(q256, full, idx, bs)
        want = T.binned_rescore_plain(q256, full, idx, bs)
        torch.cuda.synchronize()
        err = T.max_abs_err(got, want)
        require(err <= tol_for(want), f"binned_rescore {tag} at the serving bins: max|d| {err}")
        print(f"  binned_rescore {tag} at the serving bins B={B} kb={kb}: max|d| {err:.3g}",
              flush=True)
        ms = cuda_ms(lambda: T.binned_rescore(q256, full, idx, bs))
        plain = cuda_ms(lambda: T.binned_rescore_plain(q256, full, idx, bs))
        lib = cuda_ms(lambda: torch.einsum("bd,bksd->bks", q256, c3[idx.long()].float()))
        n_bins = int(torch.unique(idx).numel())  # each selected bin read once
        k5 = _row("binned_rescore", "models_tpu_torch/csrc/binned_rescore.cu",
                  "models_tpu/ops/topk.py:208", launches["binned_rescore"],
                  max(errs["binned_rescore"], err), ms, plain, lib, 2 * B * kb * bs * D,
                  n_bins * bs * D * item + B * D * 4 + B * kb * 4 + B * kb * bs * 4)
        print(f"  {tag}: phase A selects kb={kb} bins per row, {n_bins} distinct", flush=True)
        if tag == "fp32":
            rows = [k6, k5]
        else:
            bf16 = {"streaming_topk": k6, "binned_rescore": k5}
    return rows, bf16


def main() -> int:
    from models_tpu_torch.ops import kernels
    from models_tpu_torch.ops import topk as T

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(SEED)

    t = time.perf_counter()
    kernels.build()
    print(f"kernels built in {time.perf_counter() - t:.1f} s", flush=True)
    for name, log in kernels.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {regs}", flush=True)

    print("phase 1: kernels against their plain versions", flush=True)
    errs = phase_kernels(dev, gen)

    print("phase 2: serving", flush=True)
    model, catalog, queries = build_model(dev)
    T.streaming_topk.launches = 0
    T.binned_rescore.launches = 0
    t = time.perf_counter()
    results, timing = phase_serving(dev, model, catalog, queries)
    torch.cuda.synchronize()
    launches = {"streaming_topk": T.streaming_topk.launches,
                "binned_rescore": T.binned_rescore.launches}
    print(f"  served in {time.perf_counter() - t:.1f} s, launches {launches}", flush=True)
    for name, n in launches.items():
        require(n > 0, f"the serving path never launched {name}")
    check_serving(dev, model, queries, results)

    print("phase 3: times", flush=True)
    for tag in ("fp32", "bf16"):
        for B in (256, 4096):
            enc = results[(tag, B)][0]
            ds = queries.take(B)
            timing[f"predict_{tag}_B{B}_ms"] = host_ms(
                lambda: enc.predict(ds, batch_size=B, device=dev))
    timing.update(serving_breakdown(dev, model, queries, results))
    print("serving " + json.dumps(timing), flush=True)
    rows, bf16 = phase_measure(dev, model, queries, results, launches, errs)
    print("bf16 index " + json.dumps(bf16), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
