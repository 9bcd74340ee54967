"""optimizer_roofline_share.train: the dense optimizer's kernels (torch's
``_foreach`` kernels, ``multi_tensor_apply_kernel``, which
``blocks/optimizer.py``'s Adagrad runs) against their roofline: the least
time the card needs to move the bytes the update needs (the rows each step
looked up and the dense parameters: ``gpubench/work.py::adagrad_bytes``),
over their device time in the traced window."""


def _is_optimizer(name: str) -> bool:
    return "multi_tensor_apply_kernel" in name


def read(r):
    if r.trace is None or not r.work.get("optimizer_bytes"):
        return None
    t = r.trace.kernel_s(_is_optimizer)
    if not t:
        return None
    return 100.0 * r.work["optimizer_bytes"] / r.peaks["bytes_per_s"] / t
