"""Joining the ranks of a run (``models_tpu/parallel/distributed.py``).

The JAX package is one controller per host and ``jax.distributed`` wires the
hosts into one runtime. The port runs one process per rank: each joins the
``torch.distributed`` process group, and a mesh (``parallel/mesh.py``) is
built over the group's ranks. A run starts its ranks with ``torchrun
--nproc-per-node=N`` (which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) or with
:func:`~models_tpu_torch.parallel.launch.spawn`, and each rank calls
:func:`initialize` first. With no cluster in the environment and no
arguments it does nothing, as the JAX package's does.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.device import DeviceLike, resolve_device

# what initialize() chose: the rank's device and the group's backend
_STATE: dict = {}


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               device: DeviceLike = None, timeout: float = 300.0) -> Optional[torch.device]:
    """Join the process group; returns this rank's device, or None where
    there is nothing to join (no ``init_method``, no ``world_size`` and no
    ``RANK`` / ``WORLD_SIZE`` in the environment: a single process).

    ``init_method``: ``env://`` (the default: ``MASTER_ADDR`` /
    ``MASTER_PORT``), ``tcp://host:port`` or ``file://<path>``; ``rank`` and
    ``world_size`` default to ``RANK`` and ``WORLD_SIZE``. The device
    defaults to ``cuda:LOCAL_RANK`` (raising without a card) and the backend
    to ``nccl`` there; on the CPU the caller passes ``device="cpu"`` and
    ``backend="gloo"``. ``timeout`` (seconds) bounds every collective of the
    group, so that a rank that never arrives raises instead of hanging."""
    if dist.is_initialized():
        return _STATE.get("device")
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and not env:
        return None
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    dev = resolve_device(device)
    if backend is None:
        if dev.type != "cuda":
            raise ValueError("on the CPU pass backend='gloo' (NCCL runs on the card only)")
        backend = "nccl"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on the card, not on {dev}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=float(timeout)), **kwargs)
    _STATE.update(device=dev, backend=backend, timeout=float(timeout))
    return dev


def shutdown() -> None:
    """Leave the process group (nothing where none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def rank_device() -> Optional[torch.device]:
    """The device :func:`initialize` chose, or None."""
    return _STATE.get("device") if dist.is_initialized() else None


def backend() -> Optional[str]:
    return _STATE.get("backend") if dist.is_initialized() else None


def timeout() -> float:
    return _STATE.get("timeout", 300.0)


def local_loader_kwargs() -> dict:
    """``Loader`` keyword arguments that give each rank its own rows:
    ``{"global_size": world, "global_rank": rank}`` (1 and 0 alone)."""
    if not dist.is_initialized():
        return {"global_size": 1, "global_rank": 0}
    return {"global_size": dist.get_world_size(), "global_rank": dist.get_rank()}
