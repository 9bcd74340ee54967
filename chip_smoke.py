"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the port's CUDA kernels from ``models_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source, all at once) and prints their ptxas registers
   (flash_ce's per kernel, with spills and shared memory);
3. holds each kernel against its plain PyTorch version on the card: the top-k
   kernels at the shapes the serving path gives them, fp32 and bf16, with
   padding and planted ties, the streaming kernel also at k=256 and k=512
   and with few query rows over a 1M-row catalog (more than 32 catalog splits
   per row); the flash-CE kernels (forward K1, backward K2 and K3) at
   Q = N = 8192, D = 128 with downscoring, planted duplicate ids and MIN_FLOAT
   biases (K2 and K3 twice, equal bit for bit), at Q=1000, N=3001, T=0.7
   with zero weights and no ids, at D = 64, 100 and 256, at Q = 8191,
   N = 8193 and at N = 40 (fewer negatives than K3 has chunks); the row
   scatters (K7 add, K8 write) bit for bit, fp32 and bf16 tables, on the
   userId table at the path's batch (deduplicated skewed ids, stale
   duplicates and out-of-range ids on invalid positions), 81,920 ids over
   24 rows, D = 64, 200 and 130, misaligned rows, N = 1 and no valid
   position; the row gather (K9) bit for bit, fp32, bf16 and fp16 tables of
   R % 8 != 0 rows, duplicates, ids at both ends, clamped ids, B = 1, D = 7,
   a misaligned table, and 8192 ids into the bench's 4M x 128 fp32 and
   16M x 128 bf16 tables; the int8 forms: K5 (int8 x int8 -> int32) equal,
   also at D = 130 and on a misaligned catalog, K6 with int8 rows and per-row
   scales within the fp32 tolerance, with planted ties;
4. serves the two-tower model end to end at the bench's full width
   (movielens-25m schema, query_tower=(256, 128), embedding_dim=128, seeded
   random weights) over the whole 56,680-item catalog, fp32 and bf16
   indexes: a 256-row request (the binned route, phase B in the rescore
   kernel) and a 4096-row request (the streaming kernel), each held against
   the plain route; then the int8 index: built on the card equal bit for bit
   to a CPU build, 256 rows by the binned route with ids and scores equal to
   the CPU route's, 4096 rows through K6 int8 against the plain route; the
   launch counts of each run show which kernels it ran;
5. times the requests (fp32, bf16, int8; host clock), their parts, the index
   builds and the top-k layer on the bench's 1M x 128 catalog at B = 256;
6. checks the training step at the same width: the fused loss (K1-K3) against
   the unfused head (materialised logits, cuBLAS fp32, autograd) at batch
   8192, loss and every parameter's gradient; and three adagrad steps at
   batch 1024 against a CPU copy of the model (the plain versions);
7. trains at full width, the training path: ``compile("adagrad",
   learning_rate=0.05, metrics=[])`` and ``fit`` over 65,536 generated rows
   in batches of 8192 for two epochs (16 steps), requiring each of K1, K2
   and K3 to launch once per step and every loss to be finite, then serves
   the trained model (256 rows, fp32 index);
8. times the train step (host clock, median and range, examples/s), splits
   it with CUDA events into host batch and copy, tower forward, loss forward,
   backward and optimizer step, and traces four steps with torch.profiler
   (the device's busy share, the largest kernels' time per step);
9. checks row-sparse training (``embedding_optimizer="adagrad"``) with fp32
   and with bf16 tables: three steps at batch 1024 on the card and on a CPU
   copy, both rounding with the CPU generator's noise;
10. trains row-sparsely at full width: 16 steps of 8192 rows with fp32 tables
   (K7 six times a step: acc and table of userId, movieId and genres) and
   with bf16 tables (K7 three times, K8 three times), K1-K3 once a step,
   finite losses, rows no batch looked up unchanged, the trained models
   serving 256 rows;
11. times those steps as in 8, with a row-sparse update part, the bench's
   op-level steps (sparse adagrad on a 4M x 128 fp32 table, dense adagrad on
   the same as its yardstick, sparse adagrad on a 16M x 128 bf16 table), and
   K7, K8 (bf16) and K8's fp32 instance on the 4M-row table;
12. runs the row gather through its entry point (8192 ids into the 4M x 128
   fp32 and 16M x 128 bf16 tables, four calls each) and times it;
13. evaluates, the README's flow at full width: ``compile(metrics=None,
   train_metrics_steps=4)`` and ``fit`` for 8 steps of 8192 rows (K1-K3
   must launch on exactly the 6 steps without metrics), in-batch
   ``evaluate`` at batch 8192 and ``evaluate(item_corpus=...)`` with fp32,
   bf16 and int8 indexes (K6, 2048 queries) against a CPU copy, and times
   both (examples/s);
14. prints one JSON line with each kernel's launches (on its own path's run;
   K7 and K8: both row-sparse runs), error against its plain version, its
   time, the plain version's, the least time the card could take and a
   PyTorch yardstick's (the bound at the peak of the arithmetic each kernel
   runs: fp32, 3xTF32 for K2 and K3, or HBM3 bytes, named in
   ``bound_peak``), then the card line and ``{"ok": true, ...}`` last.
   Host-clock times are [median, min, max].

Tolerances. Top-k scores: 2e-6 of the largest |score| (fp32 sums of 128
products in another order). Flash-CE: (m, s) and the loss within 1e-5 of
their largest value, gradients within 2e-5 of the largest |gradient|: K1
sums each dot in d order and merges the exponentials over 16 lanes and the
negative splits, K2 and K3 compute their products as 3xTF32 on the tensor
cores (about 2^-21 relative per product) and sum the chunks in order, where
the plain versions sum with cuBLAS (TF32 off) and tile by tile. Training:
loss within 1e-5, every parameter's gradient within 2e-5 of the model's
largest |gradient| (the unfused path rounds a log-softmax over
8193 columns, and sums the embedding gradients in another order); after
three steps on the card and on the CPU, losses within 1e-5 and parameters
within 1e-5 absolute. Row scatters: bit for bit (one fp32 add or one copy per
element). Row-sparse steps, card vs CPU: as training, slots included; a bf16
table element may be one bf16 ulp off where the two sides' fp32 sums differ
in the last bits and the noise falls between them (at most 1e-3 of the
elements written).

Row gather: bit for bit (a copy). int8: the binned route's ids and scores
bit-equal card vs CPU (integer dots); K6 int8 within the top-k tolerance.
Evaluation, card vs CPU: loss within 1e-5, metrics within METRIC_ATOL.

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

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, TF32 on
# the tensor cores, HBM3. K2/K3 run 3xTF32: three TF32 products per product
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32 = (PEAK_TF32_FLOPS / 3, "3xTF32")
PEAK_FP32 = (PEAK_FP32_FLOPS, "fp32")
PEAK_BYTES_PER_S = 3.35e12
REL_TOL = 2e-6  # fp32 sums of 128 products taken in another order
FCE_TOL = 1e-5  # flash-CE (m, s) and loss, of their largest |value|
FCE_GRAD_TOL = 2e-5  # flash-CE gradients, of the largest |gradient|
TRAIN_GRAD_TOL = 2e-5  # fused vs unfused gradients, of the model's largest |gradient|
PARAM_ATOL = 1e-5  # card vs CPU parameters after three steps
TRAIN_BATCH = 8192
SEED = 0
CATALOG = 56_680  # movieIds 0..56679
K = 10
USER_ROWS = 162_544  # the userId table, padded to a multiple of 8
# device_ms: device events a trace may miss (or hold extra) over whole calls.
# At most 2 cannot round a kernel launched once a call away (reps >= 5)
LOST_EVENTS_MAX = 2
# the bench's op-level embedding-optimizer tables (bench.py:40)
OP_ROWS_FP32, OP_ROWS_BF16 = 4_000_000, 16_000_000


T0 = time.perf_counter()


def stamp(what: str) -> None:
    """A progress line with the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:.1f} s] {what}", flush=True)


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


def device_ms(fn, reps: int = 50, warmup: int = 5, cold: bool = False) -> float:
    """Device time of one call of ``fn``: the kernels and copies ``reps``
    calls put on the card (torch.profiler), each at its mean duration, as
    many times as one call launches it. For calls of a few microseconds,
    where back-to-back events would time the host's launches instead.
    ``cold``: before each call, rewrite a 128 MB buffer (its kernel is left
    out of the sum), so that the call finds its rows in device memory and not
    in the 50 MB L2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(32 << 20, device="cuda") if cold else None

    def call():
        if cold:
            flush.mul_(1.0)  # a MulFunctor kernel: none of the timed calls runs one
        fn()

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    # the profiler loses device events now and then (on an H100 under
    # torch 2.11: a trace with none, and traces short of 1-24 of 50 calls'
    # events), so a call's time is each kernel's mean duration times the
    # number of times a call launches it (its count over `reps`, rounded). A
    # trace more than LOST_EVENTS_MAX events off whole calls, or with no
    # device time, is taken again; the fifth such trace fails the run
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) \
                    and not (cold and "MulFunctor" in e.name):
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        lost = sum(abs(n - round(n / reps) * reps) for n, _ in by_name.values())
        per_call_us = sum(us / n * round(n / reps) for n, us in by_name.values())
        if per_call_us > 0 and lost <= LOST_EVENTS_MAX:
            if lost:
                print(f"  device_ms: {lost} device events missing or extra over {reps} calls",
                      flush=True)
            return per_call_us / 1e3
        print(f"  device_ms: trace {attempt + 1}: {lost} device events missing or extra over "
              f"{reps} calls, device time {per_call_us:.3f} us a call; taken again", flush=True)
    raise AssertionError("device_ms: five traces in a row lost device events or saw none")


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


def _row(name, source, replaces, launches, err, ms, plain, lib, flops, nbytes, peak=PEAK_FP32):
    """A kernel's entry of the kernels line. ``peak``: the rate of the
    arithmetic the kernel runs, (FLOP/s, its name), named in ``bound_peak``."""
    ops_ms = flops / peak[0] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_peak": peak[1] if ops_ms >= bytes_ms else "HBM3", "library_ms": lib,
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    want = want.double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return max_err(got, want) / max(scale, 1e-30)


def max_err(got, want) -> float:
    from models_tpu_torch.ops.topk import max_abs_err

    return max_abs_err(got, want)


def fce_case(dev, gen, Q, N, D, T, ids, bias_min, zero_w):
    """Seeded flash-CE inputs: ids with planted duplicates (in-batch: the
    negatives' ids are the positives'), a bias with MIN_FLOAT where the row
    is invalid (its embedding zeroed, as the head does), row weights."""
    from models_tpu_torch.core.constants import MIN_FLOAT

    q = torch.randn(Q, D, device=dev, generator=gen) * 0.3
    pos = torch.randn(Q, D, device=dev, generator=gen) * 0.3
    neg = torch.randn(N, D, device=dev, generator=gen) * 0.3
    pid = nid = bias = None
    if ids:
        pid = torch.randint(0, CATALOG, (Q,), device=dev, generator=gen, dtype=torch.int32)
        pid[1000:1100] = pid[7]
        nid = pid[:N].contiguous() if N <= Q else torch.randint(
            0, CATALOG, (N,), device=dev, generator=gen, dtype=torch.int32)
    if bias_min:
        bias = torch.zeros(N, device=dev)
        bias[::97] = MIN_FLOAT
        neg[::97] = 0.0
    w = torch.ones(Q, device=dev)
    if zero_w:
        w[::5] = 0.0
    pos_logit = ((q * pos).sum(1) / T).contiguous()
    return q, pos_logit, neg, pid, nid, bias, w


def check_fce(name, dev, args, T, errs, repeat=False):
    """K1, K2 and K3 against their plain versions on the same inputs;
    ``repeat``: K2 and K3 again, to the same bits (the chunk merge is ordered)."""
    from models_tpu_torch.ops import contrastive as C
    from models_tpu_torch.ops import flash_ce as F

    q, pos_logit, neg, pid, nid, bias, w = args
    ds = pid is not None
    m, s = F.lse_forward(q, pos_logit, neg, pid, nid, bias, T, ds)
    pm, ps = F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, ds)
    loss, ploss = (C._loss_from_lse(pos_logit, a, b, w) for a, b in ((m, s), (pm, ps)))
    lse = (pm + torch.log(ps)).contiguous()
    gw = (w / w.sum()).contiguous()
    dq = F.grad_query(q, neg, lse, gw, pid, nid, bias, T, ds)
    pdq = F.grad_query_plain(q, neg, lse, gw, pid, nid, bias, T, ds)
    dn = F.grad_neg(q, neg, lse, gw, pid, nid, bias, T, ds)
    pdn = F.grad_neg_plain(q, neg, lse, gw, pid, nid, bias, T, ds)
    torch.cuda.synchronize()
    for what, got, want, tol in (("m", m, pm, FCE_TOL), ("s", s, ps, FCE_TOL),
                                 ("loss", loss[None], ploss[None], FCE_TOL),
                                 ("dq", dq, pdq, FCE_GRAD_TOL), ("dneg", dn, pdn, FCE_GRAD_TOL)):
        require(bool(torch.isfinite(got).all()), f"flash-CE {name}: non-finite {what}")
        err = rel_err(got, want)
        require(err <= tol, f"flash-CE {name}: {what} off by {err:.3g} of its size (tol {tol})")
    require(not dq[gw == 0].any(), f"flash-CE {name}: zero-weight rows have a gradient")
    if repeat:
        again = (F.grad_query(q, neg, lse, gw, pid, nid, bias, T, ds),
                 F.grad_neg(q, neg, lse, gw, pid, nid, bias, T, ds))
        torch.cuda.synchronize()
        require(all(torch.equal(raw_bits(a), raw_bits(b)) for a, b in zip((dq, dn), again)),
                f"flash-CE {name}: K2 / K3 differ from one call to the next")
    errs["lse_forward"] = max(errs["lse_forward"], max_err(m, pm), max_err(s, ps))
    errs["grad_query"] = max(errs["grad_query"], max_err(dq, pdq))
    errs["grad_neg"] = max(errs["grad_neg"], max_err(dn, pdn))
    print(f"  flash-CE {name}: rel m {rel_err(m, pm):.3g} s {rel_err(s, ps):.3g} "
          f"loss {rel_err(loss[None], ploss[None]):.3g} dq {rel_err(dq, pdq):.3g} "
          f"dneg {rel_err(dn, pdn):.3g}", flush=True)


def phase_flash_ce(dev, gen, errs):
    """K1-K3 against their plain versions at the training path's shapes (K2
    and K3 twice, bit-equal), at ragged shapes (against every tile and chunk;
    fewer negatives than K3 has chunks), at a width that is no multiple of 8
    and at the widths the design holds."""
    cases = (("Q=N=8192 D=128 downscore bias", 8192, 8192, 128, 1.0, True, True, False),
             ("Q=1000 N=3001 D=64 T=0.7 zero weights", 1000, 3001, 64, 0.7, False, False, True),
             ("Q=N=2048 D=64 downscore bias", 2048, 2048, 64, 1.0, True, True, False),
             ("Q=N=2048 D=256 T=0.7 downscore", 2048, 2048, 256, 0.7, True, False, True),
             ("Q=N=2048 D=100 downscore bias", 2048, 2048, 100, 1.0, True, True, True),
             ("Q=8191 N=8193 D=128 T=0.7 downscore bias", 8191, 8193, 128, 0.7, True, True, True),
             ("Q=8192 N=40 D=128 downscore bias", 8192, 40, 128, 1.0, True, True, True))
    for name, Q, N, D, T, ids, bias_min, zero_w in cases:
        check_fce(name, dev, fce_case(dev, gen, Q, N, D, T, ids, bias_min, zero_w), T, errs,
                  repeat=Q == N == 8192)


def head_grads(model, xb, yb, fused):
    """(loss, {parameter: gradient}) of one training forward and backward,
    through the fused loss or the unfused head."""
    from models_tpu_torch.core.types import ModelContext

    model.contrastive_output.fused_loss = "auto" if fused else False
    model.zero_grad(set_to_none=True)
    ctx = ModelContext(features=xb, targets=yb, step=0, need_logits=False)
    preds = model(xb, targets=yb, training=True, context=ctx)
    total, _ = model._compute_losses(model._as_pred_dict(preds), xb, model._resolve_task_losses())
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.contrastive_output.fused_loss = "auto"
    model.zero_grad(set_to_none=True)
    return float(total.detach()), grads


def phase_train_checks(dev, model):
    """The kernel path against two independent ones: the unfused head at batch
    8192, and the same three steps on a CPU copy (plain versions)."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.core.types import to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    ds = mt.generate_data("movielens-25m", num_rows=TRAIN_BATCH, seed=SEED + 4)
    x, y = next(iter(Loader(ds, TRAIN_BATCH)))
    xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    fused_loss, fused = head_grads(model, xb, yb, fused=True)
    plain_loss, plain = head_grads(model, xb, yb, fused=False)
    err = abs(fused_loss - plain_loss) / abs(plain_loss)
    require(err <= FCE_TOL, f"fused loss {fused_loss} vs unfused {plain_loss}")
    # against the model's largest |gradient|: the last candidate bias has a
    # true gradient of exactly 0 (a shift of every candidate cancels in the
    # softmax), so its own scale is rounding noise
    scale = max(float(g.abs().max()) for g in plain.values())
    worst = max(max_err(fused[n], plain[n]) for n in plain) / scale
    require(worst <= TRAIN_GRAD_TOL, f"fused vs unfused gradients off by {worst:.3g}")
    print(f"  batch {TRAIN_BATCH}: fused loss {fused_loss:.7f} vs unfused {plain_loss:.7f} "
          f"(rel {err:.3g}); gradients off by {worst:.3g} of the largest |gradient| "
          f"{scale:.3g}, at worst over {len(plain)} parameters", flush=True)
    stamp("the same steps on the card and on a CPU copy")

    small = mt.generate_data("movielens-25m", num_rows=1024, seed=SEED + 5)
    on_card, on_cpu = copy.deepcopy(model), copy.deepcopy(model).to("cpu")
    hist = {}
    for tag, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
        stamp(f"3 steps on the {tag}")
        m.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
        hist[tag] = m.fit(small, epochs=3, batch_size=1024, shuffle=False,
                          device=d).history["loss"]
    np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=FCE_TOL)
    cpu_params = dict(on_cpu.named_parameters())
    worst = max(max_err(p.detach().cpu(), cpu_params[n].detach())
                for n, p in on_card.named_parameters())
    require(worst <= PARAM_ATOL, f"card and CPU parameters differ by {worst:.3g}")
    print(f"  3 adagrad steps at batch 1024, card vs CPU: losses {hist['card']} vs "
          f"{hist['cpu']}; parameters max|d| {worst:.3g}", flush=True)


def flash_launches():
    from models_tpu_torch.ops import flash_ce as F

    return {"lse_forward": F.lse_forward.launches, "grad_query": F.grad_query.launches,
            "grad_neg": F.grad_neg.launches}


def phase_train(dev, model, catalog, queries):
    """The training path at full width: fit 16 steps of 8192 rows, then serve
    the trained model. Each flash-CE counter must rise by one per step."""
    import models_tpu_torch as mt
    from models_tpu_torch.ops import flash_ce as F

    data = mt.generate_data("movielens-25m", num_rows=8 * TRAIN_BATCH, seed=SEED + 3)
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[])
    F.lse_forward.launches = F.grad_query.launches = F.grad_neg.launches = 0
    t = time.perf_counter()
    hist = model.fit(data, epochs=2, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    launches = flash_launches()
    steps = 2 * data.num_rows // TRAIN_BATCH
    print(f"  fit {steps} steps in {time.perf_counter() - t:.2f} s: loss "
          f"{hist.history['loss']}, launches {launches}", flush=True)
    for name, n in launches.items():
        require(n == steps, f"the training path launched {name} {n} times in {steps} steps")
    require(all(np.isfinite(hist.history["loss"])), "non-finite training loss")
    enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, device=dev)
    out = enc.predict(queries.take(256), batch_size=256, device=dev)
    require(out["scores"].shape == (256, K) and np.isfinite(out["scores"]).all(),
            "the trained model serves non-finite scores")
    require(((out["ids"] >= 0) & (out["ids"] < CATALOG)).all(), "trained model: ids out of range")
    print("  the trained model serves 256 rows", flush=True)
    return data, launches, {"fit_loss": hist.history["loss"],
                            "fit_examples_per_sec": hist.history["examples_per_sec"]}


def train_times(dev, model, data):
    """The train step on the host clock (each step ends in a synchronise), and
    its parts on CUDA events recorded at ``train_step``'s marks and at the end
    of the towers' forward: host batch and copy, tower forward, loss forward
    (K1), backward (K2, K3, the towers, the embedding gradients), dense
    optimizer step, row-sparse update (dedup, gathers, K7, K8; none without an
    embedding optimizer). Event times are device time between marks, launch
    gaps included."""
    from models_tpu_torch.core.types import to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    loss_fns = model._resolve_task_losses()
    t = time.perf_counter()
    batches = list(Loader(data, TRAIN_BATCH, drop_last=True))
    out = {"host_assemble_ms": (time.perf_counter() - t) * 1e3 / len(batches)}
    it = iter(batches * 4)

    def step():
        x, y = next(it)
        model.train_step(to_device_batch(x, dev), to_device_targets(y, dev), loss_fns)

    out["step_ms"] = host_ms(step, reps=12)
    out["examples_per_sec"] = TRAIN_BATCH / out["step_ms"][0] * 1e3
    names = ("batch_copy", "towers", "loss_forward", "backward", "optimizer", "sparse_update")
    sums = dict.fromkeys(names, 0.0)
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    hook = model.blocks[0].register_forward_hook(lambda *_: mark("towers"))
    reps = 8
    try:
        for x, y in batches[:reps]:
            ev.clear()
            mark("start")
            xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
            mark("batch_copy")
            model.train_step(xb, yb, loss_fns, mark=mark)
            torch.cuda.synchronize()
            require(sorted(ev) == sorted(names + ("start",)), f"train step marks {sorted(ev)}")
            for prev, name in zip(("start",) + names, names):
                sums[name] += ev[prev].elapsed_time(ev[name])
    finally:
        hook.remove()
    out.update({f"{name}_ms": v / reps for name, v in sums.items()})
    return out


def train_profile(dev, model, data, steps: int = 4):
    """A torch.profiler trace of ``steps`` train steps: the device's busy
    share of the window (kernels and copies over host wall time) and the
    device time per step of the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from models_tpu_torch.core.types import to_device_batch, to_device_targets
    from models_tpu_torch.data import Loader

    loss_fns = model._resolve_task_losses()
    batches = list(Loader(data, TRAIN_BATCH, drop_last=True))[:steps]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for x, y in batches:
            model.train_step(to_device_batch(x, dev), to_device_targets(y, dev), loss_fns)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = {}
    for e in prof.events():
        # kernels and copies; an annotation range on the device timeline
        # (the optimizer's "Optimizer.step#...") would count its kernels twice
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False) or e.name.startswith("Optimizer.")):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    require(busy > 0, "the profiler saw no device time in the train steps")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_share": busy / wall_us,
            "device_ms_per_step": busy / steps / 1e3,
            "top_kernels_ms_per_step": [[n[:90], v / steps / 1e3] for n, v in top]}


def measure_flash_ce(dev, model, data, launches, errs):
    """K1-K3 timed on the inputs the training path gives them (the towers'
    outputs for one batch, in-batch negatives, downscoring, the valid rows'
    zero bias), beside the plain versions and PyTorch yardsticks over the
    materialised logits (never called by the port)."""
    from models_tpu_torch.core.constants import MIN_FLOAT
    from models_tpu_torch.core.types import ModelContext, to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import flash_ce as F

    x, _ = next(iter(Loader(data, TRAIN_BATCH, drop_last=True)))
    xb = to_device_batch(x, dev)
    with torch.no_grad():
        towers = model.blocks[0](xb, context=ModelContext(features=xb))
    q, neg = towers["query"].contiguous(), towers["candidate"].contiguous()
    valid = xb["__row_valid__"].bool()
    neg = torch.where(valid[:, None], neg, 0.0).contiguous()
    bias = torch.where(valid, 0.0, MIN_FLOAT).contiguous()
    pid = nid = xb[model.item_id_name].to(torch.int32).contiguous()
    pos_logit = (q * towers["candidate"]).sum(1).contiguous()
    T, (Q, D), N = 1.0, q.shape, neg.shape[0]
    check_fce("the training path's inputs", dev,
              (q, pos_logit, neg, pid, nid, bias, valid.float()), T, errs)
    m, s = F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, True)
    lse = (m + torch.log(s)).contiguous()
    gw = torch.full_like(lse, 1.0 / Q)

    def logits():
        x = torch.where(nid[None, :] == pid[:, None], MIN_FLOAT, q @ neg.T + bias)
        return x / T

    def coef():
        return gw[:, None] * torch.exp(logits() - lse[:, None]) / T

    args = (q, neg, lse, gw, pid, nid, bias, T, True)
    vec = 4 * (2 * Q + 2 * N)  # pid, nid, bias and one per-row f32 input
    rows = []
    # K1 in fp32 FMAs; K2 and K3 as 3xTF32 on the tensor cores
    for name, line, fn, plain, lib, flops, nbytes, peak in (
            ("lse_forward", 76, lambda: F.lse_forward(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: torch.logsumexp(torch.cat([pos_logit[:, None], logits()], 1), 1),
             2 * Q * N * D, (Q + N) * D * 4 + vec + 2 * Q * 4, PEAK_FP32),
            ("grad_query", 134, lambda: F.grad_query(*args), lambda: F.grad_query_plain(*args),
             lambda: coef() @ neg, 4 * Q * N * D, (Q + N) * D * 4 + vec + 4 * Q + Q * D * 4,
             PEAK_3XTF32),
            ("grad_neg", 184, lambda: F.grad_neg(*args), lambda: F.grad_neg_plain(*args),
             lambda: coef().T @ q, 4 * Q * N * D, (Q + N) * D * 4 + vec + 4 * Q + N * D * 4,
             PEAK_3XTF32)):
        rows.append(_row(name, "models_tpu_torch/csrc/flash_ce.cu",
                         f"models_tpu/ops/flash_ce.py:{line}", launches[name], errs[name],
                         cuda_ms(fn), cuda_ms(plain, reps=3), cuda_ms(lib, reps=3), flops,
                         nbytes, peak))
    return rows


# ---------------------------------------------------------------------------
# row-sparse and bf16-at-rest embedding training
# ---------------------------------------------------------------------------


def raw_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def skewed_ids(n: int, card: int, seed: int) -> np.ndarray:
    """Ids with the data generator's popularity skew (id 0 reserved)."""
    p = 1.0 / np.arange(2, card + 1) ** 0.75
    return np.random.default_rng(seed).choice(np.arange(1, card), size=n,
                                              p=p / p.sum()).astype(np.int32)


def scatter_case(dev, gen, R, D, N, dtype, ids, valid=None, errs=None):
    """Kernel against plain version, both scatters, on copies of one table:
    the results must be equal bit for bit; ``errs`` keeps each kernel's
    largest |difference|. ``ids`` None: a deduplicated skewed batch, its
    stale duplicates then marked invalid and their ids moved out of range,
    so that the kernel must skip them unread."""
    from models_tpu_torch.ops import scatter as S

    if ids is None:
        raw = torch.as_tensor(skewed_ids(N, R - 3, SEED + N + D), device=dev)
        ids, _, valid = S.dedup_rows(raw, torch.zeros(N, 1, device=dev))
        ids = torch.where(valid | (torch.arange(N, device=dev) % 2 == 0), ids,
                          torch.where(torch.arange(N, device=dev) % 4 == 1, 999_999, -7))
        ids = ids.to(torch.int32).contiguous()
    table = torch.randn(R, D, device=dev, generator=gen).to(dtype)
    upd = torch.randn(N, D, device=dev, generator=gen)
    rows = torch.randn(N, D, device=dev, generator=gen).to(dtype)
    for name, fn, plain, arg in (("add", S.row_scatter_add, S.row_scatter_add_plain, upd),
                                 ("write", S.row_scatter_write, S.row_scatter_write_plain, rows)):
        got, want = fn(table.clone(), ids, arg, valid), plain(table.clone(), ids, arg, valid)
        err = max_err(got.float(), want.float())
        errs[f"row_scatter_{name}"] = max(errs[f"row_scatter_{name}"], err)
        require(torch.equal(raw_bits(got), raw_bits(want)),
                f"row_scatter_{name} R={R} D={D} N={N} {dtype}: differs from the plain version "
                f"(max|d| {err})")
    n_valid = N if valid is None else int(valid.sum())
    return n_valid


def phase_row_scatter(dev, gen, errs):
    """K7 and K8 against their plain versions, bit for bit: the userId table
    at the path's batch (a deduplicated skewed batch with stale duplicates
    and out-of-range ids on invalid positions), genres-like (81,920 ids over
    24 rows), D = 64 and 200, D = 130 and misaligned rows (the scalar path),
    fp32 and bf16 tables, N = 1 and no valid position."""
    from models_tpu_torch.ops import scatter as S

    errs["row_scatter_add"] = errs["row_scatter_write"] = 0.0
    cases = [(USER_ROWS, 128, 8192), (24, 128, 81_920), (4096, 64, 2048), (4096, 200, 2048),
             (4096, 130, 2048)]
    for R, D, N in cases:
        for dtype in (torch.float32, torch.bfloat16):
            n_valid = scatter_case(dev, gen, R, D, N, dtype, None, errs=errs)
            print(f"  row scatters R={R} D={D} N={N} {dtype}: {n_valid} valid, bit-equal",
                  flush=True)
    one = torch.tensor([5], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        none = torch.zeros(512, dtype=torch.bool, device=dev)
        scatter_case(dev, gen, 64, 128, 1, dtype, one, errs=errs)
        scatter_case(dev, gen, 64, 128, 1, dtype, one, none[:1], errs=errs)
        ids = torch.randperm(4096, device=dev, generator=gen)[:512].to(torch.int32)
        scatter_case(dev, gen, 4096, 128, 512, dtype, ids, none, errs=errs)
    # rows one element off 16-byte alignment take the scalar path
    table = torch.randn(4096, 128, device=dev, generator=gen)
    buf = torch.randn(512 * 128 + 1, device=dev, generator=gen)
    upd = buf[1:].view(512, 128)
    ids = torch.randperm(4096, device=dev, generator=gen)[:512].to(torch.int32)
    got = S.row_scatter_add(table.clone(), ids, upd)
    want = S.row_scatter_add_plain(table.clone(), ids, upd)
    errs["row_scatter_add"] = max(errs["row_scatter_add"], max_err(got, want))
    require(torch.equal(raw_bits(got), raw_bits(want)), "row_scatter_add, misaligned updates")
    print("  row scatters N=1, no valid position, misaligned rows: bit-equal", flush=True)


def sparse_launches():
    from models_tpu_torch.ops import scatter as S

    return {**flash_launches(), "row_scatter_add": S.row_scatter_add.launches,
            "row_scatter_write": S.row_scatter_write.launches}


def zero_launches():
    from models_tpu_torch.ops import flash_ce as F
    from models_tpu_torch.ops import scatter as S

    for fn in (F.lse_forward, F.grad_query, F.grad_neg, S.row_scatter_add, S.row_scatter_write):
        fn.launches = 0


def cpu_noise(shape, salt, step, device):
    """The rounding noise of the CPU's generator, wherever the table lies."""
    from models_tpu_torch.blocks.optimizer import draw_noise

    return draw_noise(shape, salt, step, "cpu").to(device)


def compile_sparse(model):
    model.compile(optimizer="adagrad", learning_rate=0.05, metrics=[],
                  embedding_optimizer="adagrad")
    return model


def seen_ids(data, batch) -> dict:
    """Every id each column's lookups see in ``fit`` over ``data`` (padding
    included), as numpy."""
    from models_tpu_torch.data import Loader

    seen = {}
    for x, _ in Loader(data, batch, drop_last=True):
        for name in ("userId", "movieId", "genres"):
            v = getattr(x[name], "values", x[name])
            seen.setdefault(name, []).append(np.ravel(v))
    return {k: np.unique(np.concatenate(v)) for k, v in seen.items()}


def phase_sparse_checks(dev, models):
    """Three row-sparse adagrad steps at batch 1024 on the card and on a CPU
    copy, both rounding bf16 tables with the CPU generator's noise. Losses
    within 1e-5; dense parameters, fp32 tables and the acc slots within
    PARAM_ATOL; a bf16 table element may differ by one bf16 ulp where the
    two sides' fp32 sums differ in the last bits and the noise falls
    between them (at most 1e-3 of the elements the steps wrote)."""
    import copy

    import models_tpu_torch as mt

    small = mt.generate_data("movielens-25m", num_rows=1024, seed=SEED + 5)
    written = seen_ids(small, 1024)
    for tag, model in models.items():
        on_card, on_cpu = copy.deepcopy(model), copy.deepcopy(model).to("cpu")
        hist = {}
        for side, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
            compile_sparse(m)._emb_opt.noise = cpu_noise
            hist[side] = m.fit(small, epochs=3, batch_size=1024, shuffle=False,
                               device=d).history["loss"]
        np.testing.assert_allclose(hist["card"], hist["cpu"], rtol=FCE_TOL)
        cpu = {**dict(on_cpu.named_parameters()), **dict(on_cpu.named_buffers())}
        worst, flips, n_written = 0.0, 0, 0
        for name, t in list(on_card.named_parameters()) + list(on_card.named_buffers()):
            got, want = t.detach().cpu(), cpu[name].detach()
            if got.dtype == torch.bfloat16:
                d = (got.float() - want.float()).abs()
                # one bf16 ulp is at most 2**-7 of the larger neighbour
                ulp = torch.maximum(got.float().abs(), want.float().abs()) * 2.0 ** -7
                require(bool((d <= ulp).all()), f"{tag}: {name} off by more than one bf16 ulp")
                flips += int((d > 0).sum())
                n_written += len(written[name.split(".")[-2]]) * got.shape[1]
            else:
                worst = max(worst, max_err(got, want))
        require(worst <= PARAM_ATOL, f"{tag}: card and CPU differ by {worst:.3g}")
        require(flips <= 1e-3 * max(n_written, 1), f"{tag}: {flips} bf16 rounding flips")
        print(f"  3 sparse adagrad steps at batch 1024, {tag} tables, card vs CPU: losses "
              f"{hist['card']} vs {hist['cpu']}; fp32 parameters and slots max|d| {worst:.3g}"
              + (f"; bf16 elements one ulp apart {flips} of {n_written} written"
                 if n_written else ""), flush=True)


def phase_sparse_train(dev, models, catalog, queries):
    """The slice's path at full width: fit 16 steps of 8192 rows with
    ``embedding_optimizer="adagrad"``, fp32 tables and bf16 tables. Each step
    must launch K1-K3 once, K7 six times with fp32 tables (acc and table of
    userId, movieId and genres) or three times with K8 three times with bf16
    tables; losses finite; rows no batch looked up unchanged; the trained
    model serves 256 rows."""
    import models_tpu_torch as mt

    data = mt.generate_data("movielens-25m", num_rows=8 * TRAIN_BATCH, seed=SEED + 3)
    steps = 2 * data.num_rows // TRAIN_BATCH
    seen = seen_ids(data, TRAIN_BATCH)
    launches, out = {}, {}
    for tag, model in models.items():
        compile_sparse(model)
        tables = {t.block_name: t for t in model._embedding_tables()}
        before = {n: t.table.detach().clone() for n, t in tables.items()}
        zero_launches()
        t = time.perf_counter()
        hist = model.fit(data, epochs=2, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
        torch.cuda.synchronize()
        launches[tag] = n = sparse_launches()
        print(f"  fit {steps} sparse steps, {tag} tables, in {time.perf_counter() - t:.2f} s: "
              f"loss {hist.history['loss']}, launches {n}", flush=True)
        k7, k8 = (6, 0) if tag == "fp32" else (3, 3)
        want = {"lse_forward": steps, "grad_query": steps, "grad_neg": steps,
                "row_scatter_add": k7 * steps, "row_scatter_write": k8 * steps}
        require(n == want, f"{tag} tables: launches {n}, want {want}")
        require(all(np.isfinite(hist.history["loss"])), f"{tag} tables: non-finite loss")
        for name, table in tables.items():
            require(table.table.dtype == (torch.float32 if tag == "fp32" else torch.bfloat16),
                    f"{name} changed dtype")
            keep = np.setdiff1d(np.arange(table.table.shape[0]), seen[name])
            keep = torch.as_tensor(keep, device=dev)
            require(torch.equal(raw_bits(table.table.detach()[keep]), raw_bits(before[name][keep])),
                    f"{tag}: rows of {name} that no batch looked up changed")
            require(not torch.equal(table.table.detach(), before[name]), f"{name} never moved")
        enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, device=dev)
        res = enc.predict(queries.take(256), batch_size=256, device=dev)
        require(res["scores"].shape == (256, K) and np.isfinite(res["scores"]).all(),
                f"{tag}: the trained model serves non-finite scores")
        out[f"sparse_{tag}_fit_loss"] = hist.history["loss"]
        out[f"sparse_{tag}_fit_examples_per_sec"] = hist.history["examples_per_sec"]
    print("  rows outside the batches unchanged; the trained models serve 256 rows", flush=True)
    return data, launches, out


def opt_step_times(dev, gen):
    """The bench's op-level embedding-optimizer steps (``bench.py:837-875``)
    through the port's optimizer, B = 8192 uniform ids per step (new ones
    each step), D = 128: row-sparse adagrad on a 4M-row fp32 table (dedup,
    gathers, two K7), the dense adagrad step on the same table as its
    yardstick (a full (R, D) gradient, accumulator and update, plain torch),
    and row-sparse adagrad on a 16M-row bf16 table (K7 on acc, stochastic
    rounding, K8). Per step: device time (``device_ms``) and wall time of
    back-to-back steps (CUDA events, which the host's launch rate sets when
    the device work is small)."""
    import torch.nn.functional as Fn

    from models_tpu_torch.blocks.optimizer import SparseEmbeddingOptimizer
    from models_tpu_torch.inputs.embedding import EmbeddingTable
    from models_tpu_torch.schema import create_categorical_column

    B, D = 8192, 128
    out = {}
    for tag, R, dtype in (("sparse_adagrad_4M_fp32", OP_ROWS_FP32, torch.float32),
                          ("sparse_adagrad_16M_bf16", OP_ROWS_BF16, torch.bfloat16)):
        table = EmbeddingTable(D, create_categorical_column("item", R - 1), dtype=dtype,
                               seed=SEED, device=dev)
        opt = SparseEmbeddingOptimizer("adagrad", 0.05)
        opt.init_slots(table)
        ids = [torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
               for _ in range(128)]
        g = torch.full((B, D), 1e-6, device=dev)
        steps = iter(range(10 ** 6))

        def step():
            t = next(steps)
            opt.apply(table, ids[t % len(ids)], g, t)

        out[f"{tag}_device_ms"] = device_ms(step, reps=50)
        out[f"{tag}_wall_ms"] = cuda_ms(step, reps=50, warmup=3)
        del table, opt
        torch.cuda.empty_cache()
    R = OP_ROWS_FP32
    w = torch.full((R, D), 1e-12, device=dev, requires_grad=True)
    acc = torch.full((R, D), 0.1, device=dev)
    ids = [torch.randint(0, R, (B,), device=dev, generator=gen) for _ in range(5)]
    steps = iter(range(10 ** 6))

    def dense_step():
        w.grad = None
        (Fn.embedding(ids[next(steps) % len(ids)], w).sum() * 1e-6).backward()
        with torch.no_grad():
            acc.addcmul_(w.grad, w.grad)
            w.sub_(0.05 * w.grad / (acc.sqrt() + 1e-8))

    out["dense_adagrad_4M_fp32_device_ms"] = device_ms(dense_step, reps=5, warmup=2)
    out["dense_adagrad_4M_fp32_wall_ms"] = cuda_ms(dense_step, reps=5, warmup=1)
    del w, acc
    torch.cuda.empty_cache()
    return out


def measure_row_scatter(dev, gen, launches, errs):
    """K7 and K8 timed at the op-level step's shape (a 4M x 128 table, a
    deduplicated batch of 8192 ids) and at the model's (the userId table,
    162,544 x 128), beside the plain versions and ``index_add_`` /
    ``index_copy_`` on the valid ids compacted beforehand. K7 on an fp32
    table, K8 on a bf16 one, as the path runs them. Times are device time
    per call from the profiler with the L2 flushed before each call
    (``device_ms(cold=True)``), as the bound assumes; the times with the rows
    left in L2 by the call before, and the back-to-back event time of the
    wrappers (the host's launch rate), are printed beside."""
    from models_tpu_torch.ops import scatter as S

    B, D = 8192, 128
    rows, extra = [], {}
    for R in (OP_ROWS_FP32, USER_ROWS):
        raw = torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
        ids, _, valid = S.dedup_rows(raw, torch.zeros(B, 1, device=dev))
        ids_v = ids[valid].long()
        n = int(valid.sum())
        upd = torch.randn(B, D, device=dev, generator=gen)
        for name, line, dtype, fn, plain, lib, nbytes in (
                ("row_scatter_add", 372, torch.float32, S.row_scatter_add,
                 S.row_scatter_add_plain, lambda t, a, a_v: t.index_add_(0, ids_v, a_v),
                 3 * n * D * 4 + B * 5),
                ("row_scatter_write", 243, torch.bfloat16, S.row_scatter_write,
                 S.row_scatter_write_plain, lambda t, a, a_v: t.index_copy_(0, ids_v, a_v),
                 2 * n * D * 2 + B * 5)):
            table = torch.randn(R, D, device=dev, generator=gen).to(dtype)
            arg = upd if name == "row_scatter_add" else upd.to(dtype)
            arg_v = arg[valid]
            def kernel():
                return fn(table, ids, arg, valid)

            ms = device_ms(kernel, cold=True)
            plain_ms = device_ms(lambda: plain(table, ids, arg, valid), reps=10, cold=True)
            lib_ms = device_ms(lambda: lib(table, arg, arg_v), cold=True)
            row = _row(name, "models_tpu_torch/csrc/row_scatter.cu",
                       f"models_tpu/ops/scatter.py:{line}", launches[name], errs[name], ms,
                       plain_ms, lib_ms, 0, nbytes)
            extra[f"{name}_R{R}"] = {
                **{k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                "l2_warm_ms": device_ms(kernel),
                "library_l2_warm_ms": device_ms(lambda: lib(table, arg, arg_v)),
                "back_to_back_ms": cuda_ms(kernel, reps=50)}
            if R == OP_ROWS_FP32:
                rows.append(row)
            del table
        print(f"  R={R}: {n} of {B} ids valid", flush=True)
    print("row scatters " + json.dumps(extra), flush=True)
    return rows


# ---------------------------------------------------------------------------
# the row gather (K9), and the int8 forms of K5 and K6
# ---------------------------------------------------------------------------


def gather_case(name, table, ids, errs):
    """K9 against its plain version: equal bit for bit."""
    from models_tpu_torch.ops import embedding_lookup as E

    got, want = E.row_gather(table, ids), E.row_gather_plain(table, ids)
    torch.cuda.synchronize()
    require(got.dtype == table.dtype and got.shape == want.shape, f"row_gather {name}: "
            f"{got.dtype} {tuple(got.shape)}")
    err = max_err(got.float(), want.float())
    errs["row_gather"] = max(errs["row_gather"], err)
    require(torch.equal(raw_bits(got), raw_bits(want)),
            f"row_gather {name}: differs from the plain version (max|d| {err})")
    print(f"  row_gather {name}: bit-equal", flush=True)


def phase_gather(dev, gen, errs):
    """K9 against its plain version, bit for bit: fp32, bf16 and fp16 tables
    of R % 8 != 0 rows, duplicates, ids at both ends, B = 1 and B not a
    multiple of 256, ids out of range (clamped), D = 7 (the scalar path), a
    table one element off 16-byte alignment; and at the bench's op-level
    sizes, 8192 ids into 4M x 128 fp32 and 16M x 128 bf16 tables."""
    errs["row_gather"] = 0.0
    R = 1003
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        table = torch.randn(R, 128, device=dev, generator=gen).to(dtype)
        ids = torch.randint(0, R, (1000,), device=dev, generator=gen, dtype=torch.int32)
        ids[:6] = torch.tensor([0, R - 1, 5, 5, 5, R - 1], dtype=torch.int32)
        ids[500:503] = torch.tensor([-3, R, R + 77], dtype=torch.int32)  # clamped
        gather_case(f"R={R} D=128 B=1000 {dtype}", table, ids, errs)
        gather_case(f"R={R} D=128 B=1 {dtype}", table, ids[1:2].contiguous(), errs)
        narrow = torch.randn(R, 7, device=dev, generator=gen).to(dtype)
        gather_case(f"R={R} D=7 {dtype}", narrow, ids, errs)
        buf = torch.randn(R * 128 + 1, device=dev, generator=gen).to(dtype)
        gather_case(f"R={R} D=128 misaligned {dtype}", buf[1:].view(R, 128), ids, errs)
    for R, dtype in ((OP_ROWS_FP32, torch.float32), (OP_ROWS_BF16, torch.bfloat16)):
        table = torch.empty(R, 128, device=dev, dtype=dtype).normal_(generator=gen)
        ids = torch.randint(0, R, (8192,), device=dev, generator=gen, dtype=torch.int32)
        ids[:2] = torch.tensor([0, R - 1], dtype=torch.int32)
        gather_case(f"R={R} D=128 B=8192 {dtype}", table, ids, errs)
        del table
    torch.cuda.empty_cache()


def quantized_catalog(dev, gen, C, D=128, per_bin=True):
    """Random int8 rows and positive fp32 scales, one per 64-row bin."""
    c8 = torch.randint(-127, 128, (C, D), device=dev, generator=gen, dtype=torch.int8)
    n_scales = -(-C // 64) if per_bin else C
    scale = torch.rand(n_scales, device=dev, generator=gen) * 0.03 + 0.002
    if per_bin:
        scale = scale.repeat_interleave(64)[:C].contiguous()
    return c8, scale


def phase_int8_kernels(dev, gen, errs):
    """The int8 forms: K5 (int8 x int8 -> int32) bit-equal to its plain
    version at the serving bins, at D = 130 (no whole 4-byte words) and on a
    misaligned catalog; K6 with int8 rows and per-row scales within the fp32
    tolerance, with planted ties, at the serving sizes and over 1M rows; and
    the int8 binned route where its product pads (D = 130, 5 query rows, 37
    rows past the last bin), card and CPU equal bit for bit."""
    from models_tpu_torch.ops import topk as T

    errs["binned_rescore_int8"] = errs["streaming_topk_int8"] = 0.0
    for D, offset in ((128, 0), (130, 0), (128, 1)):
        q8 = torch.randint(-127, 128, (256, D), device=dev, generator=gen, dtype=torch.int8)
        buf = torch.randint(-127, 128, (886 * 64 * D + offset,), device=dev, generator=gen,
                            dtype=torch.int8)
        c8 = buf[offset:].view(886 * 64, D)
        idx = torch.randint(0, 886, (256, 12), device=dev, generator=gen, dtype=torch.int32)
        got = T.binned_rescore(q8, c8, idx, 64)
        want = T.binned_rescore_plain(q8, c8, idx, 64)
        torch.cuda.synchronize()
        require(got.dtype == torch.int32 and torch.equal(got, want),
                f"binned_rescore int8 D={D} offset={offset}: differs from the plain version")
        print(f"  binned_rescore int8 B=256 kb=12 bs=64 D={D} offset={offset}: equal",
              flush=True)
    for B, C, n_valid, k in ((4096, 56_704, CATALOG, K), (16, 56_704, CATALOG, 512),
                             (8, 1_000_000, None, K)):
        q = torch.randn(B, 128, device=dev, generator=gen)
        c8, scale = quantized_catalog(dev, gen, C, per_bin=False)
        scale[7] = 1.0  # row 7 and its copies outscore every row against row 7
        for dup in (C // 3, C // 2, (n_valid or C) - 1):  # planted ties
            c8[dup], scale[dup] = c8[7], scale[7]
        got = T.streaming_topk(q, c8, k, n_valid=n_valid, scale=scale)
        want = T.streaming_topk_plain(q, c8, k, n_valid=n_valid, scale=scale)
        err = check_topk(f"streaming_topk int8 B={B} C={C} n_valid={n_valid} k={k}", got, want,
                         positions=True)
        errs["streaming_topk_int8"] = max(errs["streaming_topk_int8"], err)
        s, pos = T.streaming_topk(c8[7:8].float().contiguous(), c8, 4, n_valid=n_valid,
                                  scale=scale)
        require(pos[0, :4].tolist() == sorted(pos[0, :4].tolist()) and pos[0, 0].item() == 7,
                f"int8 planted ties resolved as {pos.tolist()}")
    C = 886 * 64 + 37
    c8, scale = quantized_catalog(dev, gen, C, D=130)
    for B in (5, 256):
        q = torch.randn(B, 130, device=dev, generator=gen)
        args = dict(n_valid=C - 7, col_scale_per_bin=True)
        s, i = T.binned_topk(q, c8, K, col_scale=scale, device=dev, **args)
        cs, ci = T.binned_topk(q.cpu(), c8.cpu(), K, col_scale=scale.cpu(), device="cpu", **args)
        require(torch.equal(i.cpu(), ci) and torch.equal(raw_bits(s.cpu()), raw_bits(cs)),
                f"int8 binned route B={B} D=130 C={C}: card and CPU differ")
        print(f"  int8 binned route B={B} D=130 C={C}: card and CPU equal", flush=True)


# ---------------------------------------------------------------------------
# the int8 index, evaluation
# ---------------------------------------------------------------------------


def phase_serving_int8(dev, model, catalog, queries):
    """The int8 index of the catalog, built on the card and on the CPU from
    the same embeddings, equal bit for bit; 256 rows by the binned route (K5
    int8) on the card and the CPU from the same query embeddings, ids equal
    and scores bit-equal; 4096 rows through K6 int8, held against the plain
    route. Returns the encoder, the launch counts and the index build time."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T
    from models_tpu_torch.outputs.topk import BruteForce

    T.streaming_topk.launches = T.binned_rescore.launches = 0
    t = time.perf_counter()
    enc = model.to_top_k_encoder(catalog, k=K, batch_size=1024, candidate_dtype=torch.int8,
                                 device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t) * 1e3
    bf = enc.blocks[-1].topk_layer
    require(bf.candidates.dtype == torch.int8 and bf.candidates.shape == (56_704, 128)
            and bf.n_valid == CATALOG and bf.scales_per_bin, "int8 index layout")
    for B in (256, 4096):
        before = T.streaming_topk.launches, T.binned_rescore.launches
        out = enc.predict(queries.take(B), batch_size=B, device=dev)
        ran = T.streaming_topk.launches > before[0], T.binned_rescore.launches > before[1]
        require(ran == (B == 4096, B == 256), f"int8 B={B}: K6, K5 ran {ran}")
        require(out["scores"].shape == (B, K) and np.isfinite(out["scores"]).all()
                and ((out["ids"] >= 0) & (out["ids"] < CATALOG)).all(), f"int8 B={B} output")
    torch.cuda.synchronize()
    launches = {"streaming_topk_int8": T.streaming_topk.launches,
                "binned_rescore_int8": T.binned_rescore.launches}
    print(f"  int8 index built in {build_ms:.1f} ms, launches {launches}", flush=True)

    emb = model.candidate_embeddings(catalog, batch_size=1024, device=dev)
    on_card = BruteForce(K).index(emb.to_numpy_dict()["embedding"],
                                  emb.to_numpy_dict()["id"], dtype=torch.int8, device=dev)
    on_cpu = BruteForce(K).index(emb.to_numpy_dict()["embedding"],
                                 emb.to_numpy_dict()["id"], dtype=torch.int8, device="cpu")
    for name in ("candidates", "ids", "scales"):
        a, b = getattr(on_card, name).cpu(), getattr(on_cpu, name)
        require(torch.equal(raw_bits(a) if a.is_floating_point() else a,
                            raw_bits(b) if b.is_floating_point() else b),
                f"int8 index: {name} built on the card differs from the CPU build")
    require(torch.equal(bf.candidates.cpu(), on_cpu.candidates), "encoder's int8 index")
    x, _ = next(iter(Loader(queries, 4096)))
    with torch.no_grad():
        q4096 = model.query_encoder(to_device_batch(x, dev)).contiguous()
    q256 = q4096[:256]
    s, i = on_card(q256)
    cs, ci = on_cpu(q256.cpu())
    torch.cuda.synchronize()
    require(torch.equal(i.cpu(), ci), "int8 binned route: ids differ from the CPU route's")
    require(torch.equal(raw_bits(s.cpu()), raw_bits(cs)),
            "int8 binned route: scores differ from the CPU route's")
    print("  int8 index: card build equals the CPU build bit for bit; 256 rows, binned "
          "route, ids and scores equal to the CPU route's", flush=True)
    want = T.streaming_topk_plain(q4096, bf.candidates, K, ids=bf.ids, n_valid=bf.n_valid,
                                  scale=bf.scales)
    check_topk("serve int8 B=4096 vs plain", bf(q4096), want)
    return enc, launches, build_ms, q4096


def evaluate_model(dev, catalog):
    """A full-width two-tower compiled with the default metrics, every 4th
    step feeding them."""
    import models_tpu_torch as mt

    model = mt.TwoTowerModel(catalog.schema, query_tower=(256, 128), embedding_dim=128,
                             seed=SEED + 7, device=dev)
    model.compile(optimizer="adagrad", learning_rate=0.05, train_metrics_steps=4)
    return model


def phase_evaluate(dev, catalog):
    """The README's flow at full width: ``fit`` 8 steps of 8192 rows with the
    default top-k metrics on every 4th step (K1 must launch on exactly the
    other 6), in-batch ``evaluate`` at batch 8192 against a CPU copy (loss
    within FCE_TOL, metrics within METRIC_ATOL), then ``evaluate(item_corpus=
    ...)`` over the 56,680-item catalog with fp32, bf16 and int8 indexes,
    2048 queries a batch (K6 on the card, the plain route on the CPU copy),
    metrics within METRIC_ATOL."""
    import copy

    import models_tpu_torch as mt
    from models_tpu_torch.ops import flash_ce as F
    from models_tpu_torch.ops import topk as T

    model = evaluate_model(dev, catalog)
    data = mt.generate_data("movielens-25m", num_rows=8 * TRAIN_BATCH, seed=SEED + 8)
    zero_launches()
    hist = model.fit(data, epochs=1, batch_size=TRAIN_BATCH, shuffle=False, device=dev)
    torch.cuda.synchronize()
    launches = flash_launches()
    print(f"  fit 8 steps with metrics every 4th: {hist.history}, launches {launches}",
          flush=True)
    require(all(n == 6 for n in launches.values()),
            f"K1-K3 launched {launches}, want 6 (the steps without metrics)")
    require(all(np.isfinite(v).all() for v in hist.history.values()), "non-finite history")
    require(0.0 <= hist.history["recall_at_10"][0] <= 1.0, "recall out of range")
    stamp("in-batch evaluate, card and CPU")

    small = mt.generate_data("movielens-25m", num_rows=TRAIN_BATCH, seed=SEED + 9)
    cpu_model = copy.deepcopy(model).to("cpu")
    got = model.evaluate(small, batch_size=TRAIN_BATCH, device=dev)
    want = cpu_model.evaluate(small, batch_size=TRAIN_BATCH, device="cpu")
    compare_eval("in-batch evaluate, batch 8192", got, want, TRAIN_BATCH)
    stamp("corpus evaluate, card and CPU")

    # 2048 queries (K6's side of the route), each labelled with an item the
    # card ranks in its fp32 top 10, at rank r % 10: the metrics then move
    # with every rank the two sides place differently
    q_rows = small.take(2048)
    top = model.to_top_k_encoder(catalog, k=K, device=dev).predict(q_rows, batch_size=2048,
                                                                   device=dev)
    cols = q_rows.to_numpy_dict()
    cols["movieId"] = top["ids"][np.arange(2048), np.arange(2048) % K].astype(np.int32)
    q_rows = mt.Dataset(cols, schema=q_rows.schema)
    corpus_launches = {}
    for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        before = T.streaming_topk.launches
        if dtype is None:  # the entry point; it builds the fp32 index itself
            got = model.evaluate(q_rows, batch_size=2048, item_corpus=catalog, k=K, device=dev)
            torch.cuda.synchronize()
            corpus_launches[tag] = T.streaming_topk.launches - before
            want = cpu_model.evaluate(q_rows, batch_size=2048, item_corpus=catalog, k=K,
                                      device="cpu")
        else:
            card_enc = model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype, device=dev)
            got = card_enc.evaluate(q_rows, batch_size=2048, device=dev)
            torch.cuda.synchronize()
            corpus_launches[tag] = T.streaming_topk.launches - before
            # the CPU copy serves the card's index: an element of a bf16 index
            # encoded on each side may round one bf16 ulp apart (and move an
            # int8 row to another bin); the int8 build itself was held bit
            # for bit against the CPU's above
            cpu_enc = cpu_model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype,
                                                 device="cpu")
            src, dst = card_enc.blocks[-1].topk_layer, cpu_enc.blocks[-1].topk_layer
            # what the copy's own index gives, printed: not a check
            own = cpu_enc.evaluate(q_rows, batch_size=2048, device="cpu")
            differ = dst.candidates != src.candidates.cpu()
            print(f"  the CPU copy's own {tag} index differs from the card's in "
                  f"{int(differ.sum())} of {differ.numel()} elements; its metrics from the "
                  f"card's by {max(abs(got[k] - own[k]) for k in got):.3g} at most", flush=True)
            for name in ("candidates", "ids", "scales"):
                value = getattr(src, name)
                setattr(dst, name, None if value is None else value.cpu())
            want = cpu_enc.evaluate(q_rows, batch_size=2048, device="cpu")
        require(corpus_launches[tag] == 1,
                f"corpus evaluate {tag}: K6 ran {corpus_launches[tag]} times")
        compare_eval(f"corpus evaluate, {tag} index, 2048 queries", got, want, 2048)
    return model, data, small, {**launches, "streaming_topk_corpus": corpus_launches}


# metrics, card vs CPU: the scores differ in the last bits, so a row whose
# relevant item is near-tied with a neighbour may rank it one place apart;
# one such flip at the top moves a mean by at most 0.5 / rows. Allowed: two
# flips in the in-batch evaluation (8192 rows), four in the corpus's (2048)
METRIC_ATOL = {8192: 1.25e-4, 2048: 1e-3}


def compare_eval(name, got, want, rows):
    require(list(got) == list(want), f"{name}: keys {list(got)} vs {list(want)}")
    loss_err = abs(got["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-30)
    require(loss_err <= FCE_TOL, f"{name}: loss {got['loss']} vs CPU {want['loss']}")
    worst = max(abs(got[k] - want[k]) for k in got if k != "loss")
    require(worst <= METRIC_ATOL[rows], f"{name}: metrics {got} vs CPU {want}")
    print(f"  {name}: card {got}; vs CPU: loss rel {loss_err:.3g}, metrics max|d| {worst:.3g}",
          flush=True)


def evaluate_times(dev, model, data, catalog):
    """examples/s of in-batch ``evaluate`` (65,536 rows, batch 8192) and of
    corpus ``evaluate`` (16,384 queries in batches of 4096; fp32 index, index
    build included, as the method builds it), host clock."""
    out = {}
    t = time.perf_counter()
    model.evaluate(data, batch_size=TRAIN_BATCH, device=dev)
    torch.cuda.synchronize()
    out["evaluate_in_batch_examples_per_sec"] = data.num_rows / (time.perf_counter() - t)
    q_rows = data.take(4 * 4096)
    for tag, dtype in (("fp32", None), ("int8", torch.int8)):
        t = time.perf_counter()
        enc = model.to_top_k_encoder(catalog, k=K, candidate_dtype=dtype, device=dev)
        enc.evaluate(q_rows, batch_size=4096, device=dev)
        torch.cuda.synchronize()
        out[f"evaluate_corpus_{tag}_examples_per_sec"] = q_rows.num_rows / (
            time.perf_counter() - t)
    return out


def topk_1m_times(dev, gen):
    """The top-k layer on the bench's 1M x 128 catalog (``bench.py:730-815``),
    B = 256, k = 10, fp32, bf16 and int8 indexes: CUDA events, back to back."""
    from models_tpu_torch.outputs.topk import BruteForce

    cand = torch.randn(1_000_000, 128, device=dev, generator=gen)
    q = torch.randn(256, 128, device=dev, generator=gen)
    out = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        bf = BruteForce(K).index(cand, dtype=dtype, device=dev)
        out[f"topk_1M_{tag}_B256_ms"] = cuda_ms(lambda: bf(q))
        del bf
    del cand
    torch.cuda.empty_cache()
    return out


def measure_gather(dev, gen, launches, errs):
    """K9 on the bench's op-level tables (8192 uniform ids into 4M x 128 fp32
    and 16M x 128 bf16): profiler device time per call with the L2 flushed,
    as the bound assumes, beside the plain version and ``index_select``.
    Bound: 2*n*D*itemsize + 4*n bytes. Returns the fp32 row and the bf16
    times."""
    from models_tpu_torch.ops import embedding_lookup as E

    B, D = 8192, 128
    rows, extra = [], {}
    for R, dtype in ((OP_ROWS_FP32, torch.float32), (OP_ROWS_BF16, torch.bfloat16)):
        table = torch.empty(R, D, device=dev, dtype=dtype).normal_(generator=gen)
        ids = torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
        ids_l = ids.long()
        item = table.element_size()
        ms = device_ms(lambda: E.row_gather(table, ids), cold=True)
        plain = device_ms(lambda: E.row_gather_plain(table, ids), cold=True)
        lib = device_ms(lambda: torch.index_select(table, 0, ids_l), cold=True)
        row = _row("row_gather", "models_tpu_torch/csrc/row_gather.cu",
                   "models_tpu/ops/embedding_lookup.py:38", launches, errs["row_gather"], ms,
                   plain, lib, 0, 2 * B * D * item + 4 * B)
        extra[f"row_gather_R{R}_{'fp32' if item == 4 else 'bf16'}"] = {
            **{k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "l2_warm_ms": device_ms(lambda: E.row_gather(table, ids)),
            "back_to_back_ms": cuda_ms(lambda: E.row_gather(table, ids), reps=50)}
        if dtype == torch.float32:
            rows.append(row)
        del table
    torch.cuda.empty_cache()
    print("row gather " + json.dumps(extra), flush=True)
    return rows


def measure_scatter_write_fp32(dev, gen, errs, launches):
    """K8a, the fp32 instance of the row scatter-write, timed as K8b is: a
    deduplicated batch of 8192 ids into a 4M x 128 fp32 table, L2 flushed,
    beside the plain version and ``index_copy_``. Bound: 2*n_valid*D*4 + 5*N
    bytes. ``launches``: the row-sparse run with fp32 tables counted them,
    and must have counted none (only bf16 tables are written whole rows)."""
    from models_tpu_torch.ops import scatter as S

    require(launches == 0, f"the fp32-table run launched row_scatter_write {launches} times")
    B, D, R = 8192, 128, OP_ROWS_FP32
    raw = torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
    ids, _, valid = S.dedup_rows(raw, torch.zeros(B, 1, device=dev))
    ids_v = ids[valid].long()
    n = int(valid.sum())
    table = torch.randn(R, D, device=dev, generator=gen)
    rows = torch.randn(B, D, device=dev, generator=gen)
    got = S.row_scatter_write(table.clone(), ids, rows, valid)
    want = S.row_scatter_write_plain(table.clone(), ids, rows, valid)
    require(torch.equal(raw_bits(got), raw_bits(want)), "row_scatter_write fp32 4M: differs")
    err = max(errs["row_scatter_write"], max_err(got, want))
    del got, want
    rows_v = rows[valid]
    ms = device_ms(lambda: S.row_scatter_write(table, ids, rows, valid), cold=True)
    plain = device_ms(lambda: S.row_scatter_write_plain(table, ids, rows, valid), reps=10,
                      cold=True)
    lib = device_ms(lambda: table.index_copy_(0, ids_v, rows_v), cold=True)
    row = _row("row_scatter_write_fp32", "models_tpu_torch/csrc/row_scatter.cu",
               "models_tpu/ops/scatter.py:243", launches, err, ms, plain, lib, 0,
               2 * n * D * 4 + B * 5)
    del table
    torch.cuda.empty_cache()
    return row


def measure_int8(dev, enc, q4096, launches, errs):
    """K5 and K6 int8 timed on the inputs the int8 serving path gives them:
    the int8 index of the catalog, the 256-row request's quantized queries and
    the bins phase A selects (K5), the 4096-row request's fp32 queries with
    the per-row scales (K6). Back-to-back CUDA events, as K5 and K6 are timed
    above; yardsticks: the gather and an fp32 einsum of the widened int8
    values (exact), and ``torch.topk`` of the scaled product."""
    from models_tpu_torch.ops import topk as T

    bf = enc.blocks[-1].topk_layer
    n, D = bf.n_valid, bf.candidates.shape[1]
    cand, ids, scale = bf.candidates[:n], bf.ids[:n], bf.scales[:n].contiguous()
    B = q4096.shape[0]
    ms = cuda_ms(lambda: T.streaming_topk(q4096, cand, K, ids=ids, scale=scale))
    plain = cuda_ms(lambda: T.streaming_topk_plain(q4096, cand, K, ids=ids, scale=scale),
                    reps=3)
    lib = cuda_ms(lambda: torch.topk((q4096 @ cand.float().T) * scale[None, :], K))
    k6 = _row("streaming_topk_int8", "models_tpu_torch/csrc/streaming_topk.cu",
              "models_tpu/ops/topk.py:102", launches["streaming_topk_int8"],
              errs["streaming_topk_int8"], ms, plain, lib, 2 * B * n * D,
              B * D * 4 + n * D + n * 8 + B * K * 8)
    q8, _ = T.quantize_queries(q4096[:256].contiguous())
    full, bs = bf.candidates, 64
    idx = T.select_bins(q8, full, K, n_valid=n, col_scale=bf.scales, col_scale_per_bin=True)
    B, kb = idx.shape
    c3 = full.view(-1, bs, D)
    got, want = T.binned_rescore(q8, full, idx, bs), T.binned_rescore_plain(q8, full, idx, bs)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "binned_rescore int8 at the serving bins: differs")
    ms = cuda_ms(lambda: T.binned_rescore(q8, full, idx, bs))
    plain = cuda_ms(lambda: T.binned_rescore_plain(q8, full, idx, bs))
    lib = cuda_ms(lambda: torch.einsum("bd,bksd->bks", q8.float(), c3[idx.long()].float()))
    n_bins = int(torch.unique(idx).numel())
    k5 = _row("binned_rescore_int8", "models_tpu_torch/csrc/binned_rescore.cu",
              "models_tpu/ops/topk.py:208", launches["binned_rescore_int8"],
              errs["binned_rescore_int8"], ms, plain, lib, 2 * B * kb * bs * D,
              n_bins * bs * D + B * D + B * kb * 4 + B * kb * bs * 4)
    print(f"  int8: phase A selects kb={kb} bins per row, {n_bins} distinct", flush=True)
    return [k6, k5]


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
    # flash_ce in full: each kernel's registers, static shared memory and spills
    for ln in kernels.build_logs.get("flash_ce", "").splitlines():
        if "entry function" in ln or "Used" in ln or "spill" in ln:
            print(f"    flash_ce ptxas: {ln.split(':', 1)[-1].strip()}", flush=True)
    from models_tpu_torch.ops import flash_ce as F

    print("    flash_ce grad_rows dynamic shared memory (bytes) at D = 64, 128, 256: "
          f"{[F._lib().flash_ce_grad_smem(d) for d in (64, 128, 256)]}", flush=True)

    stamp("phase 1: kernels against their plain versions")
    errs = phase_kernels(dev, gen)
    errs.update(lse_forward=0.0, grad_query=0.0, grad_neg=0.0)
    phase_flash_ce(dev, gen, errs)
    phase_row_scatter(dev, gen, errs)
    phase_gather(dev, gen, errs)
    phase_int8_kernels(dev, gen, errs)

    stamp("phase 2: serving")
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
    enc8, int8_launches, timing["index_int8_ms"], q4096 = phase_serving_int8(
        dev, model, catalog, queries)
    for name, n in int8_launches.items():
        require(n > 0, f"the int8 serving path never launched {name}")

    stamp("phase 3: times")
    for tag in ("fp32", "bf16"):
        for B in (256, 4096):
            enc = results[(tag, B)][0]
            ds = queries.take(B)
            timing[f"predict_{tag}_B{B}_ms"] = host_ms(
                lambda: enc.predict(ds, batch_size=B, device=dev))
    for B in (256, 4096):
        ds = queries.take(B)
        timing[f"predict_int8_B{B}_ms"] = host_ms(
            lambda: enc8.predict(ds, batch_size=B, device=dev))
    timing.update(serving_breakdown(dev, model, queries, results))
    timing.update(topk_1m_times(dev, gen))
    print("serving " + json.dumps(timing), flush=True)
    rows, bf16 = phase_measure(dev, model, queries, results, launches, errs)
    print("bf16 index " + json.dumps(bf16), flush=True)
    int8_rows = measure_int8(dev, enc8, q4096, int8_launches, errs)
    del enc8

    stamp("phase 4: the training step against the unfused head and the CPU")
    tmodel = model  # the serving phases are done: train the same seeded model
    phase_train_checks(dev, tmodel)

    stamp("phase 5: training at full width")
    data, train_launches, train = phase_train(dev, tmodel, catalog, queries)

    stamp("phase 6: training times")
    train.update(train_times(dev, tmodel, data))
    train.update(train_profile(dev, tmodel, data))
    print("training " + json.dumps(train), flush=True)
    rows += measure_flash_ce(dev, tmodel, data, train_launches, errs)

    stamp("phase 7: row-sparse training against the CPU")
    import models_tpu_torch as mt

    sparse_models = {tag: mt.TwoTowerModel(catalog.schema, query_tower=(256, 128),
                                           embedding_dim=128, table_dtype=dtype, seed=SEED,
                                           device=dev)
                     for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16))}
    phase_sparse_checks(dev, sparse_models)

    stamp("phase 8: row-sparse training at full width")
    data, sparse_runs, sparse = phase_sparse_train(dev, sparse_models, catalog, queries)

    stamp("phase 9: row-sparse training times")
    for tag, model in sparse_models.items():
        for key, value in {**train_times(dev, model, data),
                           **train_profile(dev, model, data)}.items():
            sparse[f"sparse_{tag}_{key}"] = value
    sparse.update(opt_step_times(dev, gen))
    print("sparse training " + json.dumps(sparse), flush=True)
    row_launches = {name: sum(run[name] for run in sparse_runs.values())
                    for name in ("row_scatter_add", "row_scatter_write")}
    rows += measure_row_scatter(dev, gen, row_launches, errs)
    rows.append(measure_scatter_write_fp32(dev, gen, errs,
                                           sparse_runs["fp32"]["row_scatter_write"]))

    stamp("phase 10: the row gather through its entry point")
    from models_tpu_torch.ops import embedding_lookup as E

    tables = [(torch.empty(R, 128, device=dev, dtype=dt).normal_(generator=gen),
               torch.randint(0, R, (8192,), device=dev, generator=gen, dtype=torch.int32))
              for R, dt in ((OP_ROWS_FP32, torch.float32), (OP_ROWS_BF16, torch.bfloat16))]
    E.row_gather.launches = 0
    for table, ids in tables:
        for _ in range(4):
            out = E.row_gather(table, ids)
            require(out.shape == (8192, 128) and out.dtype == table.dtype, "row_gather output")
    torch.cuda.synchronize()
    gather_launches = E.row_gather.launches
    require(gather_launches == 8, f"row_gather launched {gather_launches} times, want 8")
    del tables, out
    torch.cuda.empty_cache()
    rows += measure_gather(dev, gen, gather_launches, errs)

    stamp("phase 11: evaluation (fit with metrics, in-batch and corpus evaluate)")
    emodel, edata, _, eval_launches = phase_evaluate(dev, catalog)
    print(f"  launches {eval_launches}", flush=True)
    stamp("evaluation times")
    etimes = evaluate_times(dev, emodel, edata, catalog)
    print("evaluation " + json.dumps(etimes), flush=True)
    rows += int8_rows
    stamp("done")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
