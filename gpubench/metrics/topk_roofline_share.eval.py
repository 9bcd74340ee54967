"""topk_roofline_share.eval: the top-k layer's kernels (``ops/topk.py``:
K6's streaming top-k and its merge, K4's bin maxima, K5's rescore) against
their roofline: the least time the card needs for 2 B C D at the fp32 peak,
or to read the catalog once a batch with the queries and write the k best,
over their device time in the traced window."""

import re

KERNELS = {"topk_partial", "topk_merge", "bin_max_kernel", "bin_max_wg", "rescore",
           "rescore_bins", "rescore_i8"}
NAME = re.compile(r"\(anonymous namespace\)::(\w+)")


def _is_topk(name: str) -> bool:
    m = NAME.search(name)
    return m is not None and m.group(1) in KERNELS


def read(r):
    if r.trace is None or not r.work.get("topk_flops"):
        return None
    t = r.trace.kernel_s(_is_topk)
    if not t:
        return None
    bound = max(r.work["topk_flops"] / r.peaks["fp32_flops_per_s"],
                r.work["topk_bytes"] / r.peaks["bytes_per_s"])
    return 100.0 * bound / t
