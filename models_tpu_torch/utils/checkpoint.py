"""Step checkpoints and exact training resume (``models_tpu/utils/checkpoint.py``).

The JAX package writes its checkpoints with orbax; here a checkpoint is a
directory per step, ``<directory>/<step>/checkpoint.pt``, written by
``torch.save`` under a temporary name and then renamed (a crash mid-write
leaves no half checkpoint), and read with ``weights_only=True``. It holds
the model's state (``utils/io.py::model_state``: the parameters and
persistent buffers, the row-sparse slots and bf16 tables among them), and
where given the dense optimizer's state (slots, bf16 slots at rest, and
step counts), the global step and the states of the blocks' random
generators (dropout, samplers). Only ``max_to_keep`` checkpoints are kept.

On a mesh (``fit(mesh=)``) every rank calls ``save``: the sharded tables,
their slots and their optimizer slots are gathered whole (through the host)
and the chief alone writes; ``restore_training(mesh=, shard_rules=)`` reads
the whole state on every rank and places it on the mesh.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from ..core.device import check_module_device

CHECKPOINT_FILE = "checkpoint.pt"


def _generators(model) -> dict:
    """The blocks' generators by module name (``RandomBlock.generator``)."""
    return {name: m.generator for name, m in model.named_modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)}


class CheckpointManager:
    """Save and restore step checkpoints under ``directory``, keeping the
    newest ``max_to_keep``; ``save`` skips steps that are not a multiple of
    ``save_interval_steps``."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(int(save_interval_steps), 1)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, CHECKPOINT_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, opt_state=None, global_step=None) -> bool:
        """Write checkpoint ``step``: the model's state, and ``opt_state``
        and ``global_step`` where given (:meth:`BaseModel.training_state`).
        Returns False where the interval skips the step."""
        from ..parallel.mesh import barrier, full_state, is_chief
        from .io import model_state

        if step % self.save_interval_steps:
            return False
        payload = {"model": full_state(model, model_state(model)),
                   "generators": {k: g.get_state() for k, g in _generators(model).items()}}
        if not is_chief():
            barrier()  # the chief's write is done when save returns
            return True
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if global_step is not None:
            payload["global_step"] = int(global_step)
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        barrier()
        return True

    def _read(self, step: Optional[int], dev) -> tuple:
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        path = os.path.join(self.directory, str(step), CHECKPOINT_FILE)
        return step, torch.load(path, map_location=dev, weights_only=True)

    def _restore_model(self, model, payload: dict, dev) -> None:
        from .io import load_state

        load_state(model, payload["model"], dev)
        gens = _generators(model)
        for name, state in payload.get("generators", {}).items():
            if name in gens:
                gens[name].set_state(state.cpu())

    def restore(self, model, step: Optional[int] = None, device=None):
        """Restore the model's state in place (``model`` lies on ``device``,
        default the card). Returns (step, the saved optimizer state or
        None)."""
        dev = check_module_device(model, device)
        step, payload = self._read(step, dev)
        self._restore_model(model, payload, dev)
        return step, payload.get("opt_state")

    def restore_training(self, model, data=None, step: Optional[int] = None,
                         device=None, mesh=None, shard_rules=None) -> int:
        """Resume training: restore the model's state, the optimizer's and
        the global step, so that the next ``fit(initial_epoch=<returned> +
        1, ...)`` continues the interrupted run. ``model`` (on ``device``,
        default the card) is compiled as the run was; ``data`` (a Dataset or
        Loader) builds it where it has layers left to build. Returns the
        checkpoint's step (the epoch, from ``ModelCheckpoint``). The
        resumed trajectory is the uninterrupted one bit for bit where the
        batch order is (``shuffle=False``). A ``MultiOptimizer`` (its
        optimizers are made anew each fit) is refused. ``mesh`` and
        ``shard_rules``: those of the ``fit(mesh=)`` that continues, the
        model (whole, built on every rank) placed on it after the load."""
        from ..blocks.optimizer import MultiOptimizer

        if not getattr(model, "_compiled", False):
            raise ValueError("compile() the model before restore_training")
        if isinstance(model._optimizer_spec, MultiOptimizer):
            raise ValueError("restore_training does not take a MultiOptimizer (its optimizers "
                             "are made anew each fit, so their slots cannot be armed)")
        dev = check_module_device(model, device)
        if data is not None:
            model.build(data, device=dev)
        if model.unbuilt_layers():
            raise ValueError("the model has layers left to build: pass data= to build it")
        step, payload = self._read(step, dev)
        if "opt_state" not in payload:
            raise ValueError(f"checkpoint {step} has no optimizer state (saved without "
                             "training_state?)")
        if mesh is not None:
            self._restore_model(model, payload, dev)
            model._place_on_mesh(mesh, shard_rules)
            model._build_optimizer()
        else:
            if model._optimizer is None:
                model._build_optimizer()  # the row-sparse slots, which the state fills
            self._restore_model(model, payload, dev)
        model.arm_training_state(payload["opt_state"], payload.get("global_step", 0), mesh=mesh)
        return step


class ModelCheckpoint:
    """A ``fit`` callback: a checkpoint every ``every_n_epochs`` epochs
    under ``directory``, its step the epoch, holding the model's state and
    its training state (:meth:`BaseModel.training_state`)."""

    def __init__(self, directory: str, every_n_epochs: int = 1, max_to_keep: int = 3):
        self.manager = CheckpointManager(directory, max_to_keep=max_to_keep)
        self.every = every_n_epochs
        self.model = None

    def set_model(self, model):
        self.model = model

    def on_epoch_end(self, epoch, logs):
        if (epoch + 1) % self.every == 0 and self.model is not None:
            ts = self.model.training_state()
            self.manager.save(epoch, self.model,
                              opt_state=None if ts is None else ts["opt_state"],
                              global_step=None if ts is None else ts["global_step"])
