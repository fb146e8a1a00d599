"""Checkpoint and resume with ``torch.save`` — port of
``mxdetection_tpu.train.checkpoint`` (Orbax there).

A checkpoint holds the full training state of a ``Trainer``: the model's
state dict (parameters and buffers, SyncBN's running statistics too),
``ClippedSGD``'s momentum traces, the step (``ClippedSGD``'s count of
updates, which sets the learning rate) and the state of the samplers' draw
generator. Models are small and replicated, so rank 0
writes (a temporary file, then ``os.replace``) and every rank restores onto
its own device.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

from ..parallel.mesh import world_size

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    """``directory/step_<n>.pt`` for the newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, trainer, force: bool = False) -> bool:
        """Save ``trainer``'s state at its step; a step already saved is
        written again only with ``force``. Returns whether it wrote."""
        opt = trainer.optimizer
        step = opt.count
        wrote = False
        if (force or step not in self.all_steps()) and (world_size() == 1 or dist.get_rank() == 0):
            state = {
                "step": step,
                "model": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
                "trace": [m.detach().cpu() for m in opt.trace],
                "rng": trainer.draws.generator.get_state(),
            }
            tmp = self._path(step) + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
            wrote = True
        if world_size() > 1:
            dist.barrier()  # the file exists before any rank may restore it
        return wrote

    def restore(self, trainer, step: int | None = None) -> int:
        """Load the checkpoint of ``step`` (the latest by default) into
        ``trainer`` on its own device; returns the step."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        trainer.model.load_state_dict(state["model"], strict=True)
        opt = trainer.optimizer
        with torch.no_grad():
            for m, saved in zip(opt.trace, state["trace"], strict=True):
                m.copy_(saved)
        opt.count = state["step"]
        trainer.draws.generator.set_state(state["rng"])
        return state["step"]
