"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the port's CUDA kernels from ``models_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source, all at once) and prints their ptxas registers;
3. holds each kernel against its plain PyTorch version on the card: the top-k
   kernels at the shapes the serving path gives them, fp32 and bf16, with
   padding and planted ties, the streaming kernel also at k=256 and k=512
   and with few query rows over a 1M-row catalog (more than 32 catalog splits
   per row); the flash-CE kernels (forward K1, backward K2 and K3) at
   Q = N = 8192, D = 128 with downscoring, planted duplicate ids and MIN_FLOAT
   biases, at Q=1000, N=3001, T=0.7 with zero weights and no ids, and at
   D = 64 and 256;
4. serves the two-tower model end to end at the bench's full width
   (movielens-25m schema, query_tower=(256, 128), embedding_dim=128, seeded
   random weights) over the whole 56,680-item catalog, fp32 and bf16
   indexes: a 256-row request (the binned route, phase B in the rescore
   kernel) and a 4096-row request (the streaming kernel), each held against
   the plain route; the launch counts of this phase show which kernels it ran;
5. checks the training step at the same width: the fused loss (K1-K3) against
   the unfused head (materialised logits, cuBLAS fp32, autograd) at batch
   8192, loss and every parameter's gradient; and three adagrad steps at
   batch 1024 against a CPU copy of the model (the plain versions);
6. trains at full width, the training path: ``compile("adagrad",
   learning_rate=0.05, metrics=[])`` and ``fit`` over 65,536 generated rows
   in batches of 8192 for two epochs (16 steps), requiring each of K1, K2
   and K3 to launch once per step and every loss to be finite, then serves
   the trained model (256 rows, fp32 index);
7. times the train step (host clock, median and range, examples/s), splits
   it with CUDA events into host batch and copy, tower forward, loss forward,
   backward and optimizer step, and traces four steps with torch.profiler
   (the device's busy share, the largest kernels' time per step);
8. prints one JSON line with each kernel's launches (on its own path's run),
   error against its plain version, its time, the plain version's, the least
   time the card could take and a PyTorch yardstick's, then the card line and
   ``{"ok": true, ...}`` last. Host-clock times are [median, min, max].

Tolerances. Top-k scores: 2e-6 of the largest |score| (fp32 sums of 128
products in another order). Flash-CE: (m, s) and the loss within 1e-5 of
their largest value, gradients within 2e-5 of the largest |gradient|: the
kernels sum each dot in d order and merge the exponentials over 16 lanes and
the negative splits, where the plain versions sum with cuBLAS and tile by
tile. Training: loss within 1e-5, every parameter's gradient within 2e-5 of
the model's largest |gradient| (the unfused path rounds a log-softmax over
8193 columns, and sums the embedding gradients in another order); after
three steps on the card and on the CPU, losses within 1e-5 and parameters
within 1e-5 absolute.

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
FCE_TOL = 1e-5  # flash-CE (m, s) and loss, of their largest |value|
FCE_GRAD_TOL = 2e-5  # flash-CE gradients, of the largest |gradient|
TRAIN_GRAD_TOL = 2e-5  # fused vs unfused gradients, of the model's largest |gradient|
PARAM_ATOL = 1e-5  # card vs CPU parameters after three steps
TRAIN_BATCH = 8192
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


def check_fce(name, dev, args, T, errs):
    """K1, K2 and K3 against their plain versions on the same inputs."""
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
    errs["lse_forward"] = max(errs["lse_forward"], max_err(m, pm), max_err(s, ps))
    errs["grad_query"] = max(errs["grad_query"], max_err(dq, pdq))
    errs["grad_neg"] = max(errs["grad_neg"], max_err(dn, pdn))
    print(f"  flash-CE {name}: rel m {rel_err(m, pm):.3g} s {rel_err(s, ps):.3g} "
          f"loss {rel_err(loss[None], ploss[None]):.3g} dq {rel_err(dq, pdq):.3g} "
          f"dneg {rel_err(dn, pdn):.3g}", flush=True)


def phase_flash_ce(dev, gen, errs):
    """K1-K3 against their plain versions at the training path's shapes, at a
    ragged shape and at the widths the design holds."""
    cases = (("Q=N=8192 D=128 downscore bias", 8192, 8192, 128, 1.0, True, True, False),
             ("Q=1000 N=3001 D=64 T=0.7 zero weights", 1000, 3001, 64, 0.7, False, False, True),
             ("Q=N=2048 D=64 downscore bias", 2048, 2048, 64, 1.0, True, True, False),
             ("Q=N=2048 D=256 T=0.7 downscore", 2048, 2048, 256, 0.7, True, False, True))
    for name, Q, N, D, T, ids, bias_min, zero_w in cases:
        check_fce(name, dev, fce_case(dev, gen, Q, N, D, T, ids, bias_min, zero_w), T, errs)


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

    small = mt.generate_data("movielens-25m", num_rows=1024, seed=SEED + 5)
    on_card, on_cpu = copy.deepcopy(model), copy.deepcopy(model).to("cpu")
    hist = {}
    for tag, m, d in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
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
    its parts on CUDA events: host batch and copy, tower forward, loss forward
    (K1), backward (K2, K3, the towers, the embedding gradients), optimizer
    step. Event times are device time between marks, launch gaps included."""
    from models_tpu_torch.core.types import ModelContext, to_device_batch, to_device_targets
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
    names = ("batch_copy", "towers", "loss_forward", "backward", "optimizer")
    sums = dict.fromkeys(names, 0.0)
    reps = 8
    for x, y in batches[:reps]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
        ev[1].record()
        ctx = ModelContext(features=xb, targets=yb, step=model._step, need_logits=False)
        towers = model.blocks[0](xb, training=True, context=ctx, targets=yb)
        ev[2].record()
        pred = model.blocks[1](towers, training=True, context=ctx, targets=yb)
        total, _ = model._compute_losses(model._as_pred_dict(pred), xb, loss_fns)
        ev[3].record()
        model._optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[4].record()
        model._optimizer.step()
        ev[5].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            sums[name] += ev[i].elapsed_time(ev[i + 1])
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
    for name, line, fn, plain, lib, flops, nbytes in (
            ("lse_forward", 76, lambda: F.lse_forward(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: F.lse_forward_plain(q, pos_logit, neg, pid, nid, bias, T, True),
             lambda: torch.logsumexp(torch.cat([pos_logit[:, None], logits()], 1), 1),
             2 * Q * N * D, (Q + N) * D * 4 + vec + 2 * Q * 4),
            ("grad_query", 134, lambda: F.grad_query(*args), lambda: F.grad_query_plain(*args),
             lambda: coef() @ neg, 4 * Q * N * D, (Q + N) * D * 4 + vec + 4 * Q + Q * D * 4),
            ("grad_neg", 184, lambda: F.grad_neg(*args), lambda: F.grad_neg_plain(*args),
             lambda: coef().T @ q, 4 * Q * N * D, (Q + N) * D * 4 + vec + 4 * Q + N * D * 4)):
        rows.append(_row(name, "models_tpu_torch/csrc/flash_ce.cu",
                         f"models_tpu/ops/flash_ce.py:{line}", launches[name], errs[name],
                         cuda_ms(fn), cuda_ms(plain, reps=3), cuda_ms(lib, reps=3), flops,
                         nbytes))
    return rows


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
    errs.update(lse_forward=0.0, grad_query=0.0, grad_neg=0.0)
    phase_flash_ce(dev, gen, errs)

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

    print("phase 4: the training step against the unfused head and the CPU", flush=True)
    tmodel = model  # the serving phases are done: train the same seeded model
    phase_train_checks(dev, tmodel)

    print("phase 5: training at full width", flush=True)
    data, train_launches, train = phase_train(dev, tmodel, catalog, queries)

    print("phase 6: training times", flush=True)
    train.update(train_times(dev, tmodel, data))
    train.update(train_profile(dev, tmodel, data))
    print("training " + json.dumps(train), flush=True)
    rows += measure_flash_ce(dev, tmodel, data, train_launches, errs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
