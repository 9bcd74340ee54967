"""A/B timings of the row scatter-write (K8), the binned rescore (K5) and the
row gather (K9) on one NVIDIA card, each form built from its own sources and
timed in turns in one process.

    python3 ab_kernels.py [--parent DIR] [--only NAME,...] [--kernels K8,K5,K9]

Builds ``row_scatter.cu``, ``binned_rescore.cu`` and ``row_gather.cu`` from
``models_tpu_torch/csrc`` ("head"), from copies of it with a few lines of
the source changed (``VARIANTS``; ``DIAGNOSTIC`` ones skip work or keep
clocks and are not held against the plain version), and with ``--parent``
from another checkout's kernel sources (a ``csrc`` directory, e.g. one unpacked by
``git archive <commit> models_tpu_torch/csrc | tar -x -C build/parent``), one
``nvcc`` each, all started together, into ``build/ab/``. The C interfaces
are the same in every form. Each form is first held against the plain
version (the scatter bit for bit; the rescore within 2e-6 of the largest
|score|, int8 equal); then every form is timed on the same inputs, in the
order A, B, ..., then back (..., B, A), and both turns are printed:

- K8 at the bench's op-level shape: 8192 uniform ids, deduplicated, into a
  4M x 128 table, bf16 (K8b) and fp32 (K8a): profiler device time per call
  with the L2 flushed dirty before each call, flushed read-only, and warm
  (``chip_smoke.device_ms``); and on the userId table (162,544 rows, bf16)
  and genres-like (81,920 positions, 24 valid);
- K5 at the bins that phase A selects for a 256-row request of the
  two-tower model over the 56,680-item catalog (``chip_smoke.build_model``,
  seeded), fp32, bf16 and int8 indexes: back-to-back CUDA events, device
  time warm (the catalog in L2, as between requests) and with the L2
  flushed; and at the bins of a 1M x 128 catalog (B = 256,
  kb = 12), flushed dirty and read-only;
- K9 at the bench's op-level shape (8192 uniform ids into a 4M x 128 fp32
  table) and at the device-resident training route's (one chunk of 16
  batches of 8192, 131,072 ids, into the packed movielens-25m columns of
  1,048,576 rows of 26 int32): device time with the L2 flushed dirty,
  flushed read-only and warm, and back-to-back CUDA events; beside them
  ``index_select`` (``gather_no_ids``, a diagnostic, reads row j for
  position j: one round trip to memory instead of two).

``--kernels`` runs only the named sections. Prints the card's name and power
limit, each form's ptxas report, and one JSON line per measurement:
``{"what": ..., "ms": {form: [turn 1, turn 2]}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from models_tpu_torch.ops import kernels  # noqa: E402

BUILD = ROOT / "build" / "ab"
# form -> (source, the line as committed, the line in the variant)
# per block, past the output: clock64 cycles in all, to the end of the first
# scan, waiting for copies, scoring; items, pairs
TRACE = [
    ("  int used = 0;  // items copied and scored so far, the same in every thread",
     "  const long long t_begin = clock64();\n  long long t_scan = 0, t_wait = 0, t_score = 0;\n"
     "  int n_pairs = 0, n_all = 0;\n  int used = 0;  // items copied and scored so far"),
    ("    const int nb = n_items;",
     "    const int nb = n_items;\n    if (w0 == 0) t_scan = clock64();\n    n_all += nb;"),
    ("      mbar_wait(full + used % STAGES, (used / STAGES) & 1);",
     "      const long long tw = clock64();\n"
     "      mbar_wait(full + used % STAGES, (used / STAGES) & 1);\n"
     "      t_wait += clock64() - tw;"),
    ("      const int a = item_a[n], m = item_z[n] - a;\n      const unsigned char* qs",
     "      const long long ts = clock64();\n"
     "      const int a = item_a[n], m = item_z[n] - a;\n      n_pairs += m;\n"
     "      const unsigned char* qs"),
    ("      }\n    }\n    __syncthreads();  // the window's list and counts are done with",
     "      }\n      t_score += clock64() - ts;\n    }\n"
     "    __syncthreads();  // the window's list and counts are done with"),
    ("    __syncthreads();  // the window's list and counts are done with\n  }\n}",
     "    __syncthreads();  // the window's list and counts are done with\n  }\n"
     "  if (tid == 0) {\n"
     "    long long* t = reinterpret_cast<long long*>(o + (size_t)total * BS) + 8 * g;\n"
     "    t[0] = clock64() - t_begin; t[1] = t_scan - t_begin; t[2] = t_wait;\n"
     "    t[3] = t_score; t[4] = n_all; t[5] = n_pairs; t[6] = 1;\n"
     "  }\n}"),
]
# form -> (source, [(the text as committed, the text in the variant), ...])
VARIANTS = {
    "rescore_qg64": ("binned_rescore", [("constexpr int QUERY_GROUP = 32;",
                                         "constexpr int QUERY_GROUP = 64;")]),
    "rescore_qg16": ("binned_rescore", [("constexpr int QUERY_GROUP = 32;",
                                         "constexpr int QUERY_GROUP = 16;")]),
    # diagnostics, not held against the plain version: the scan and the
    # copies without the scoring, and the head form with clocks at its
    # phases (kept past the output)
    "rescore_no_score": ("binned_rescore", [("      if (g4 < m) {\n        Acc* to",
                                             "      if (g4 < 0) {\n        Acc* to")]),
    "rescore_trace": ("binned_rescore", TRACE),
    # K9's stores as streaming stores (evict first)
    "gather_cs": ("row_gather", [("if (p < pieces && j < B) out[(size_t)j * pieces + p] = v[u];",
                                  "if (p < pieces && j < B) __stcs(out + (size_t)j * pieces + p, "
                                  "v[u]);")]),
    # K9 with 4 rows a lane in flight instead of 8
    "gather_u4": ("row_gather", [("constexpr int U = 8;", "constexpr int U = 4;")]),
    # diagnostic: K9 reading row j for position j, its rows independent of
    # the ids (one round trip to memory, not two; not a gather)
    "gather_no_ids": ("row_gather", [("v[u] = load_once(table + (size_t)id[u] * pieces + p);",
                                      "v[u] = load_once(table + (size_t)(j0 + u * RPI + s) * "
                                      "pieces + p);")]),
}
DIAGNOSTIC = ("rescore_no_score", "rescore_trace", "gather_no_ids")
NAMES = ("row_scatter", "binned_rescore", "row_gather")
# the section of each source's forms
SECTION = {"row_scatter": "K8", "binned_rescore": "K5", "row_gather": "K9"}


def sources(parent):
    """form -> csrc directory; the variants are written here."""
    forms = {"head": kernels.CSRC}
    if parent:
        forms["parent"] = Path(parent).resolve()
    for form, (name, edits) in VARIANTS.items():
        d = BUILD / "src" / form
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        text = (d / f"{name}.cu").read_text()
        for line, changed in edits:
            if text.count(line) != 1:
                raise SystemExit(f"{form}: {line!r} is not once in {name}.cu")
            text = text.replace(line, changed)
        (d / f"{name}.cu").write_text(text)
        forms[form] = d
    return forms


def build(forms, names=NAMES):
    """(form, name) -> loaded library: one nvcc a source, all at once."""
    procs, libs = {}, {}
    for form, csrc in forms.items():
        out_dir = BUILD / form
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in names:
            out = kernels._target(name, csrc, out_dir)
            flags = [f if f != str(kernels.CSRC) else str(csrc) for f in kernels.NVCC_FLAGS]
            cmd = [kernels._nvcc(), *flags, "-o", str(out), str(csrc / f"{name}.cu")]
            procs[(form, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), out)
    for (form, name), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {form} {name}:\n{log}")
        ptx = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
               if "entry function" in ln or "Used" in ln or "spill" in ln
               or "warning" in ln.lower()]
        print(f"{form} {name} ptxas: {ptx}", flush=True)
        lib = ctypes.CDLL(str(out))
        p, i = ctypes.c_void_p, ctypes.c_int
        entry, args = {
            "row_scatter": ("row_scatter_write", [p, i, p, p, p, i, i, i, p]),
            "binned_rescore": ("binned_rescore", [p, p, i, p, p, i, i, i, i, i, p]),
            "row_gather": ("row_gather", [p, i, p, p, i, i, i, p])}[name]
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = args, i
        libs[(form, name)] = lib
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def write_call(lib, table, ids, rows, valid):
    R, D = table.shape
    return lambda: lib.row_scatter_write(table.data_ptr(), int(table.dtype == torch.bfloat16),
                                         ids.data_ptr(), rows.data_ptr(), valid.data_ptr(),
                                         ids.shape[0], R, D, stream())


def rescore_call(lib, q, c, idx, out, bs=64):
    code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[c.dtype]
    return lambda: lib.binned_rescore(q.data_ptr(), c.data_ptr(), code, idx.data_ptr(),
                                      out.data_ptr(), q.shape[0], q.shape[1], idx.shape[1], bs,
                                      c.shape[0] // bs, stream())


def gather_call(lib, table, ids, out):
    R, D = table.shape
    return lambda: lib.row_gather(table.data_ptr(), table.element_size(), ids.data_ptr(),
                                  out.data_ptr(), ids.shape[0], R, D, stream())


def turns(what, calls, timer):
    """Time each form's call in order, then in reverse; print and return."""
    order = list(calls) + list(reversed(calls))
    ms = {form: [] for form in calls}
    for form in order:
        ms[form].append(timer(calls[form]))
    print(json.dumps({"what": what, "ms": ms}), flush=True)
    return ms


def scatter_ab(dev, gen, libs, forms):
    from models_tpu_torch.ops import scatter as S

    cases = [(C.OP_ROWS_FP32, torch.bfloat16, 8192, None),
             (C.OP_ROWS_FP32, torch.float32, 8192, None),
             (C.USER_ROWS, torch.bfloat16, 8192, None), (24, torch.bfloat16, 81_920, 24)]
    for R, dtype, N, card in cases:
        raw = torch.randint(0, card or R, (N,), device=dev, generator=gen, dtype=torch.int32)
        ids, _, valid = S.dedup_rows(raw, torch.zeros(N, 1, device=dev))
        table = torch.randn(R, 128, device=dev, generator=gen).to(dtype)
        rows = torch.randn(N, 128, device=dev, generator=gen).to(dtype)
        want = S.row_scatter_write_plain(table.clone(), ids, rows, valid)
        calls = {}
        for form in forms:
            t = table.clone()
            fn = write_call(libs[(form, "row_scatter")], t, ids, rows, valid)
            C.require(fn() == 0, f"{form}: row_scatter_write launch failed")
            torch.cuda.synchronize()
            C.require(torch.equal(C.raw_bits(t), C.raw_bits(want)),
                      f"{form}: row_scatter_write R={R} {dtype} differs")
            del t
            calls[form] = write_call(libs[(form, "row_scatter")], table, ids, rows, valid)
        del want
        tag = f"row_scatter_write R={R} N={N} {dtype} ({int(valid.sum())} valid)"
        turns(f"{tag}, dirty flush", calls, lambda f: C.device_ms(f, cold=True))
        if R == C.OP_ROWS_FP32:
            turns(f"{tag}, read-only flush", calls, lambda f: C.device_ms(f, cold="read"))
            turns(f"{tag}, warm", calls, lambda f: C.device_ms(f))
        del table
        torch.cuda.empty_cache()


def gather_ab(dev, gen, libs, forms):
    from models_tpu_torch.ops import embedding_lookup as E

    cases = [("op-level 4M x 128 fp32", C.OP_ROWS_FP32, 128, torch.float32, 8192),
             ("pack 1,048,576 x 26 int32", 1 << 20, 26, torch.int32, 16 * C.TRAIN_BATCH)]
    for what, R, D, dtype, B in cases:
        if dtype == torch.int32:
            table = torch.randint(-2**31, 2**31 - 1, (R, D), device=dev, generator=gen,
                                  dtype=torch.int32)
        else:
            table = torch.empty(R, D, device=dev, dtype=dtype).normal_(generator=gen)
        ids = torch.randint(0, R, (B,), device=dev, generator=gen, dtype=torch.int32)
        ids_l = ids.long()
        want = E.row_gather_plain(table, ids)
        out = torch.empty_like(want)
        calls = {}
        for form in forms:
            fn = gather_call(libs[(form, "row_gather")], table, ids, out)
            out.zero_()
            C.require(fn() == 0, f"{form}: row_gather launch failed")
            torch.cuda.synchronize()
            C.require(form in DIAGNOSTIC or torch.equal(C.raw_bits(out), C.raw_bits(want)),
                      f"{form}: row_gather {what} differs")
            calls[form] = fn
        calls["index_select"] = lambda: torch.index_select(table, 0, ids_l)
        nbytes = 2 * B * D * table.element_size() + 4 * B
        print(json.dumps({"what": f"row_gather {what}, B={B}", "bound_ms":
                          nbytes / C.PEAK_BYTES_PER_S * 1e3}), flush=True)
        turns(f"row_gather {what}, dirty flush", calls, lambda f: C.device_ms(f, cold=True))
        turns(f"row_gather {what}, read-only flush", calls,
              lambda f: C.device_ms(f, cold="read"))
        turns(f"row_gather {what}, warm", calls, lambda f: C.device_ms(f))
        turns(f"row_gather {what}, back to back", calls, lambda f: C.cuda_ms(f, reps=50))
        del table, want, out
        torch.cuda.empty_cache()


def rescore_inputs(dev, gen):
    """(tag, q, catalog, bins): the serving request's and the 1M catalog's."""
    from models_tpu_torch.core.types import to_device_batch
    from models_tpu_torch.data import Loader
    from models_tpu_torch.ops import topk as T
    from models_tpu_torch.outputs.topk import BruteForce

    model, catalog, queries = C.build_model(dev)
    x, _ = next(iter(Loader(queries.take(256), 256)))
    with torch.no_grad():
        q = model.query_encoder(to_device_batch(x, dev)).contiguous()
    out = []
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        enc = model.to_top_k_encoder(catalog, k=C.K, batch_size=1024, candidate_dtype=dtype,
                                     device=dev)
        out.append((f"serving {tag}",) + select(T, q, enc.blocks[-1].topk_layer))
    cand = torch.randn(1_000_000, 128, device=dev, generator=gen)
    q1m = torch.randn(256, 128, device=dev, generator=gen)
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        out.append((f"1M {tag}",) + select(T, q1m, BruteForce(C.K).index(cand, dtype=dtype,
                                                                       device=dev)))
    return out


def select(T, q, bf):
    full, n = bf.candidates, bf.n_valid
    if full.dtype == torch.int8:
        q, _ = T.quantize_queries(q)
        return q, full, T.select_bins(q, full, C.K, n_valid=n, col_scale=bf.scales,
                                      col_scale_per_bin=bf.scales_per_bin)
    return q, full, T.select_bins(q, full, C.K, n_valid=n)


def trace(tag, clocks):
    """The trace form's per-block clocks: the slowest blocks and the mean."""
    t = clocks.view(torch.int64).view(-1, 8).cpu()
    t = t[t[:, 6] == 1, :6]
    order = torch.argsort(t[:, 0], descending=True)
    print(json.dumps({"trace": tag, "blocks": t.shape[0],
                      "columns": "cycles, to the first scan's end, waiting, scoring, items, "
                                 "pairs",
                      "mean": t.double().mean(0).tolist(), "slowest": t[order[:6]].tolist()}),
          flush=True)


def rescore_ab(dev, gen, libs, forms):
    from models_tpu_torch.ops import topk as T

    for tag, q, c, idx in rescore_inputs(dev, gen):
        want = T.binned_rescore_plain(q, c, idx, 64)
        calls = {}
        for form in forms:
            buf = torch.zeros(want.numel() + 8192, dtype=want.dtype, device=dev)
            out = buf[:want.numel()].view(want.shape)  # the trace form's clocks past it
            fn = rescore_call(libs[(form, "binned_rescore")], q, c, idx, out)
            C.require(fn() == 0, f"{form}: binned_rescore launch failed")
            torch.cuda.synchronize()
            if form == "rescore_trace":
                trace(tag, buf[want.numel():])
            if form not in DIAGNOSTIC and c.dtype == torch.int8:
                C.require(torch.equal(out, want), f"{form}: binned_rescore {tag} differs")
            elif form not in DIAGNOSTIC:
                err = T.max_abs_err(out, want)
                C.require(err <= C.tol_for(want), f"{form}: binned_rescore {tag}: max|d| {err}")
            calls[form] = fn
        B, kb = idx.shape
        what = (f"binned_rescore {tag} B={B} kb={kb}, {int(torch.unique(idx).numel())} "
                "distinct bins")
        if tag.startswith("serving"):
            turns(f"{what}, back to back", calls, lambda f: C.cuda_ms(f, reps=50))
            turns(f"{what}, warm", calls, lambda f: C.device_ms(f))
        turns(f"{what}, L2 flushed", calls, lambda f: C.device_ms(f, cold=True))
        if tag.startswith("1M"):
            turns(f"{what}, read-only flush", calls, lambda f: C.device_ms(f, cold="read"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout's csrc directory, built as 'parent'")
    ap.add_argument("--only", help="forms to build and time, comma-separated (head always)")
    ap.add_argument("--kernels", default="K8,K5,K9", help="sections to run, comma-separated")
    args = ap.parse_args()
    sections = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(C.gpu_line(), flush=True)
    forms = sources(args.parent)
    if args.only:
        keep = {"head", *args.only.split(",")}
        forms = {f: d for f, d in forms.items() if f in keep}
    names = [n for n in NAMES if SECTION[n] in sections]
    forms = {f: d for f, d in forms.items() if f not in VARIANTS or VARIANTS[f][0] in names}
    libs = build(forms, names)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(C.SEED)

    def of(name):
        return [f for f in forms if f not in VARIANTS or VARIANTS[f][0] == name]

    if "K8" in sections:
        scatter_ab(dev, gen, libs, of("row_scatter"))
    if "K5" in sections:
        rescore_ab(dev, gen, libs, of("binned_rescore"))
    if "K9" in sections:
        gather_ab(dev, gen, libs, of("row_gather"))
    print(C.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
