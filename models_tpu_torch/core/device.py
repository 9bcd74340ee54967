"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and no card is
    present, so that a GPU-less host never serves on the CPU by accident. A
    card named without an index is the current one, returned with its index
    (``cuda:0``), so that it compares equal to the device of the tensors
    made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_module_device(module: torch.nn.Module, device: DeviceLike) -> torch.device:
    """Resolve ``device`` and require that ``module``'s tensors lie on it."""
    dev = resolve_device(device)
    for t in list(module.parameters()) + list(module.buffers()):
        if t.device.type != dev.type or (
            dev.index is not None and t.device.index != dev.index
        ):
            raise ValueError(
                f"{type(module).__name__} lives on {t.device}, not on {dev}; "
                "build it there or move it with .to()"
            )
    return dev
