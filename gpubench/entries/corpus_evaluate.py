"""Corpus evaluation: ``evaluate`` of a top-k encoder over labelled queries,
back to back.

Set-up draws the queries from the seed, and the catalog and the weights (the
index) from the traffic's ``index_seed``, the same in every run: an index
evaluated on fresh queries. The streaming top-k merges a tile only where a
score passes a row's k-th best, so how much it merges follows the scores'
landscape over the catalog, which one index sets for all of its queries: an
index drawn from each seed moved the rate by some 3%. Each query's label is
the item at a rank drawn from the seed (1 to the traffic's
``label_rank_max``) of the plain reference's own scores over the whole
catalog, as a trained model ranks a user's item high: the metrics then turn
on the order of each query's best items, where a fault shows. The reference's
metrics follow from those ranks. Set-up then builds the program's model to
the configuration with the same weights, its encoder over the catalog
(``to_top_k_encoder``: the index) and evaluates ``warm_calls`` times (the
first call packs the queries and runs a chunk eagerly, a later one captures
the chunk's graph).

The window is whole ``evaluate`` calls; ``eval_examples_per_s`` is every
query evaluated in it over its wall time. The check compares each window
call's metrics with the reference's, by the widest gap, and the top-k
answer (ids and scores) of a sample of the queries, drawn from the seed,
of the window's last call: the top-k layer's outputs at one batch of the
evaluation's last chunk, held from that chunk's capture (every replay of
the chunk writes them anew), against the reference's top k of the same
queries over the whole catalog.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import compare, retrieval
from ..harness import Cell, Outcome, RunContext, import_program
from ..reference import precision
from ..tracing import trace_calls
from ..work import topk_bytes, topk_flops
from . import memory_peak, release, reset_peak, sync, timed_calls


class HeldTopK:
    """Holds the top-k layer's answer (scores, ids) at batch ``step`` of the
    evaluation's last chunk, which starts at batch ``start``: on the card,
    the tensors that the chunk's captured graph writes at that step, which
    every replay of the chunk writes anew; run eagerly (the CPU), the
    batch's own in each call (``new_call`` before each)."""

    def __init__(self, layer, step: int, start: int):
        self.step, self.start, self.calls, self.captured = step, start, 0, 0
        self.held = None
        self.handle = layer.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        if out.scores.is_cuda and torch.cuda.is_current_stream_capturing():
            take = self.captured == self.step
            self.captured += 1
        else:
            take = self.calls == self.start + self.step
        self.calls += 1
        if take:
            self.held = (out.scores, out.identifiers)

    def new_call(self) -> None:
        self.calls = 0

    def read(self) -> tuple:
        if self.held is None:
            raise RuntimeError("the top-k layer's answer at the checked batch was never held")
        return tuple(t.detach().cpu().numpy() for t in self.held)


def topk_layer(encoder):
    from models_tpu_torch.outputs.topk import BruteForce

    found = [m for m in encoder.modules() if isinstance(m, BruteForce)]
    if len(found) != 1:
        raise ValueError(f"the encoder has {len(found)} top-k layers, not one")
    return found[0]


def sample_of(seed: int, tr: dict) -> tuple:
    """The checked sample, from the seed: (the batch of the last chunk, its
    rows' positions in that batch, their query rows). Needs the batches to
    fill whole chunks, or one chunk."""
    from models_tpu_torch.models.base import EVAL_CHUNK_BATCHES

    n, B = tr["queries"], tr["batch_size"]
    batches = -(-n // B)
    chunk = min(EVAL_CHUNK_BATCHES, batches)
    if batches % chunk:
        raise ValueError(f"{batches} batches fill no whole number of chunks of {chunk}")
    start = batches - chunk
    rng = np.random.default_rng([seed, 1])
    step = int(rng.integers(0, chunk))
    first = (start + step) * B
    pos = np.sort(rng.choice(min(B, n - first), size=tr["check_rows"], replace=False))
    return start, step, pos, first + pos


@torch.no_grad()
def top_k_gaps(cfg, reference, params, catalog, queries, rows, ids, scores, k, dev) -> dict:
    """The served ``ids`` and ``scores`` of the query ``rows`` against the
    float32 reference's top ``k`` over the whole catalog."""
    n_items = retrieval.item_id_column(cfg)["max_id"] + 1
    with precision(False):
        c = retrieval.embed(reference, cfg, params, "item", catalog, n_items, dev)
        q = reference.tower(cfg, "query", params, reference.batch(cfg, queries, rows, dev))
        full = q @ c.T
        ref_scores = torch.topk(full, k, dim=1).values.cpu().numpy()
        exact = full.gather(1, torch.as_tensor(ids, dtype=torch.int64, device=dev).clamp_min(0))
    gaps = compare.served_gaps(scores, exact.cpu().numpy(), ref_scores)
    if (ids < 0).any():
        gaps = {name: float("inf") for name in gaps}
    return gaps


@torch.no_grad()
def draw(cfg: dict, tr: dict, reference, seed: int, dev) -> tuple:
    """The catalog (from the index's seed), the labelled queries and each
    label's rank (from ``seed``); the labels from the float32 reference's
    scores."""
    n = tr["queries"]
    rng = np.random.default_rng(seed)
    item = retrieval.item_id_column(cfg)
    catalog = retrieval.draw_catalog(cfg, np.random.default_rng(tr["index_seed"]),
                                     tr["id_skew"])
    queries = retrieval.draw_queries(cfg, n, rng, tr["id_skew"])
    ranks = rng.integers(1, tr["label_rank_max"] + 1, size=n)
    with precision(False):
        params = reference.make_params(cfg, tr["index_seed"], dev)
        q = retrieval.embed(reference, cfg, params, "query", queries, n, dev)
        c = retrieval.embed(reference, cfg, params, "item", catalog, item["max_id"] + 1, dev)
        queries[item["name"]] = retrieval.labels_at(q, c, ranks, reference.top_k).astype(np.int32)
    del params, q, c
    release(dev)
    return catalog, queries, ranks


def run(run: RunContext) -> Outcome:
    import_program()
    cell, cfg, tr = run.cell, run.cell.config, run.cell.traffic
    program, reference, work = cell.module("program"), cell.module("reference"), cell.module("work")
    dev = torch.device(run.device)
    B, n, k = tr["batch_size"], tr["queries"], tr["k"]
    n_items = retrieval.item_id_column(cfg)["max_id"] + 1
    catalog, queries, ranks = draw(cfg, tr, reference, run.seed, dev)
    reset_peak(dev)  # the labels' reference scores are the inputs' making, not the program's

    model = program.build(cfg, dev)
    retrieval.fill_program(program.leaves(model, cfg), reference.leaf_specs(cfg),
                           tr["index_seed"])
    encoder = model.to_top_k_encoder(program.dataset(cfg, catalog), k=k,
                                     batch_size=tr["index_batch"], device=dev)
    q_ds = program.dataset(cfg, queries)
    results = []
    start, step, pos, rows = sample_of(run.seed, tr)
    held = HeldTopK(topk_layer(encoder), step, start)

    def evaluate():
        held.new_call()
        with run.spans.span("evaluate"):
            results.append(encoder.evaluate(q_ds, batch_size=B, device=dev))

    for _ in range(tr["warm_calls"]):
        evaluate()
    counters = {"graph_capture_s": sum(s["capture_s"]
                                       for s in encoder._eval_graphs.stats.values())}
    setup_s = run.since_start()

    results.clear()
    window_s, calls, failed = timed_calls(evaluate, run.seconds)
    attempted = len(calls) * n
    metrics = {"eval_examples_per_s": (len(calls) - failed) * n / window_s, "setup_s": setup_s}
    window_results = list(results)
    served_scores, served_ids = (a[pos] for a in held.read())

    trace, traced_work = None, {}
    if run.trace:
        calls_traced = tr["trace_calls"]
        trace = trace_calls(evaluate, calls_traced, run.spans)
        batches = -(-n // B)
        D = cfg["embedding_dim"]
        traced_work = {
            "model_flops": calls_traced * (work.query_flops(cfg, n)
                                           + topk_flops(n, n_items, D)),
            "topk_flops": calls_traced * topk_flops(n, n_items, D),
            "topk_bytes": calls_traced * batches * topk_bytes(B, n_items, D, k),
        }
    sync(dev)
    peak = memory_peak(dev)
    held.handle.remove()
    del model, encoder, q_ds, held
    release(dev)

    expected = retrieval.rank_metrics(ranks, k)
    gap = max((compare.metric_gap(r, expected, sorted(expected), n) for r in window_results),
              default=float("inf"))
    checks = {"metric_gap": (gap, run.limits.get("metric_gap"))}
    params = reference.make_params(cfg, tr["index_seed"], dev)
    for name, v in top_k_gaps(cfg, reference, params, catalog, queries, rows, served_ids,
                              served_scores, k, dev).items():
        checks[name] = (v, run.limits.get(name))
    checks["failed_queries"] = (float(failed * n), 0.0)
    return Outcome(metrics, attempted, failed * n, checks, peak, trace, traced_work, counters)


CONTROLS = ("tf32",)


@torch.no_grad()
def control(cell: Cell, seed: int, device, kind: str = "tf32") -> dict:
    """The control: the plain reference put in the program's place and run
    in TF32 (towers and scores): its metrics over the seed's labelled
    queries held to the expected ones, and its top k of the run's sample
    held to the float32 reference's, by the run's own gaps."""
    if kind != "tf32":
        raise ValueError(f"no control {kind!r} for a retrieval cell")
    cfg, tr = cell.config, cell.traffic
    reference, dev = cell.module("reference"), torch.device(device)
    n, k = tr["queries"], tr["k"]
    item = retrieval.item_id_column(cfg)
    catalog, queries, ranks = draw(cfg, tr, reference, seed, dev)
    _, _, _, sample = sample_of(seed, tr)
    with precision(True):
        params = reference.make_params(cfg, tr["index_seed"], dev)
        q = retrieval.embed(reference, cfg, params, "query", queries, n, dev)
        c = retrieval.embed(reference, cfg, params, "item", catalog, item["max_id"] + 1, dev)
        scores, rows = reference.top_k(q, c, k)
    labels = torch.as_tensor(queries[item["name"]], dtype=torch.int64, device=dev)
    hit = rows == labels[:, None]
    got = torch.where(hit.any(1), hit.int().argmax(1) + 1, 0).cpu().numpy()
    expected = retrieval.rank_metrics(ranks, k)
    low = retrieval.rank_metrics(got, k)
    gaps = {"metric_gap": compare.metric_gap(low, expected, sorted(expected), n)}
    served_ids, served_scores = rows[sample].cpu().numpy(), scores[sample].cpu().numpy()
    del q, c, scores, rows
    gaps.update(top_k_gaps(cfg, reference, params, catalog, queries, sample, served_ids,
                           served_scores, k, dev))
    return gaps
