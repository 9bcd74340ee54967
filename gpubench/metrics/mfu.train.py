"""mfu.train: the training step's model FLOPs (forward and backward, no
recomputation; ``kinds/<kind>/work.py::train_flops``) done in the traced
window, over the window's length, as a share of the card's fp32 peak on
the tensor cores (TF32: no implementation that keeps fp32's accuracy
multiplies faster)."""


def read(r):
    flops = r.work.get("model_flops")
    if not flops or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * flops / r.trace.window_s / r.peaks["fp32_flops_per_s"]
