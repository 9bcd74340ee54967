"""loss_roofline_share.train: the contrastive loss's kernels (K1-K3 of
``ops/flash_ce.py``: the log-sum-exp forward and its merge, the two
gradient recomputes and their merge, in fp32 and bf16 forms) against their
roofline: the least time the card needs for the loss's three products of
2 B B D at the fp32 peak, or for its bytes at the memory's, over their
device time in the traced window."""

import re

KERNELS = {"lse_partial", "lse_merge", "lse_wg", "grad_rows", "grad_merge", "grad_wg"}
NAME = re.compile(r"\(anonymous namespace\)::(\w+)")


def _is_loss(name: str) -> bool:
    m = NAME.search(name)
    return m is not None and m.group(1) in KERNELS


def read(r):
    if r.trace is None or "loss_flops" not in r.work:
        return None
    t = r.trace.kernel_s(_is_loss)
    if not t:
        return None
    bound = max(r.work["loss_flops"] / r.peaks["fp32_flops_per_s"],
                r.work["loss_bytes"] / r.peaks["bytes_per_s"])
    return 100.0 * bound / t
