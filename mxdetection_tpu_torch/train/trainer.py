"""One training step on one device — port of ``mxdetection_tpu.train.trainer``.

``Trainer.run_step`` does what the JAX package's jitted step does, eagerly:
raw uint8 batch -> ``batch_transform`` (on the canvas of the batch's
orientation) -> ``sanitize_gt`` -> ``forward_train`` -> ``rcnn_loss`` ->
backward -> the optimizer update. The optimizer is written out to match the
optax chain ``clip_by_global_norm -> add_decayed_weights -> sgd(momentum)``
(``make_optimizer``): torch's ``clip_grad_norm_`` divides by ``norm + 1e-6``
and ``torch.optim.SGD`` decays and steps in another order.

Data parallelism, SyncBN and checkpoints are ROADMAP Queue 1 item 10; the
epoch loop ``fit_epochs`` waits for the data loader (item 15).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import Config
from ..data.transforms import batch_transform
from ..models.detectors.rcnn import rcnn_loss
from ..models.registry import build_detector, require_device
from ..ops.matching import Draws, TorchDraws
from .schedule import warmup_multistep


class ClippedSGD:
    """optax ``chain(clip_by_global_norm(grad_clip), add_decayed_weights(
    weight_decay), sgd(lr_fn, momentum))`` over a list of f32 tensors.

    Per step: g_norm = sqrt(sum |g|^2); g = g if g_norm < clip else
    g / g_norm * clip; g = g + wd * p; m = g + momentum * m; p = p - lr(t) * m
    with t the number of steps taken before this one. A parameter without a
    gradient (a frozen stage) steps with a zero gradient, so it still decays,
    as in the reference.
    """

    def __init__(self, params: Sequence[torch.Tensor], lr_fn, *, momentum: float,
                 weight_decay: float, grad_clip: float):
        self.params = list(params)
        self.lr_fn = lr_fn
        self.momentum, self.weight_decay, self.grad_clip = momentum, weight_decay, grad_clip
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor | None]) -> torch.Tensor:
        """Apply one update; returns the global norm of ``grads`` before clipping."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        g_norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        if self.grad_clip and self.grad_clip > 0:
            keep = g_norm < self.grad_clip
            grads = [torch.where(keep, g, g / g_norm * self.grad_clip) for g in grads]
        lr = self.lr_fn(self.count)
        for p, g, m in zip(self.params, grads, self.trace):
            if self.weight_decay:
                g = g + self.weight_decay * p
            m.copy_(g + self.momentum * m)
            p.add_(-lr * m)
        self.count += 1
        return g_norm


def make_optimizer(cfg: Config, params: Sequence[torch.Tensor], steps_per_epoch: int):
    """SGD(momentum) + weight decay + global-norm clip with the
    warmup-multistep LR of ``cfg.train.optim`` -> (optimizer, lr_fn)."""
    o = cfg.train.optim
    lr_fn = warmup_multistep(
        o.base_lr, warmup_steps=o.warmup_steps, warmup_ratio=o.warmup_ratio,
        decay_steps=tuple(e * steps_per_epoch for e in o.lr_decay_epochs),
        decay_factor=o.lr_decay_factor)
    opt = ClippedSGD(params, lr_fn, momentum=o.momentum, weight_decay=o.weight_decay,
                     grad_clip=o.grad_clip)
    return opt, lr_fn


def sanitize_gt(tb: dict, min_size: float = 1.0) -> dict:
    """Invalidate gt boxes that collapsed below ``min_size`` after resize."""
    b = tb["gt_boxes"]
    ok = ((b[..., 2] - b[..., 0]) >= min_size) & ((b[..., 3] - b[..., 1]) >= min_size)
    return {**tb, "gt_valid": tb["gt_valid"] & ok}


class Trainer:
    """Single-device trainer of a Faster R-CNN (``build_detector(train=True)``).

    ``model=None`` builds one from ``cfg`` on ``device`` with seeded
    weights (``seed``); a given model is moved to ``device``. The device is
    the card unless the caller asks for the CPU. The samplers' random draws
    come from a ``torch.Generator`` on the device seeded with
    ``cfg.train.seed``, unless ``run_step`` is handed another source.
    """

    def __init__(self, cfg: Config, model: torch.nn.Module | None = None, *,
                 steps_per_epoch: int = 1, device="cuda", seed: int | None = 0):
        self.cfg = cfg
        self.device = require_device(device)
        if model is None:
            model = build_detector(cfg, device=self.device, seed=seed, train=True)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.optimizer, self.lr_fn = make_optimizer(cfg, self.params, steps_per_epoch)
        gen = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.draws = TorchDraws(gen)

    def device_batch(self, batch: dict) -> dict:
        """Raw batch (numpy arrays or tensors) -> the transformed training batch."""
        batch = {k: torch.as_tensor(np.array(v) if not isinstance(v, torch.Tensor) else v)
                 .to(self.device) for k, v in batch.items()}
        portrait = bool(batch.pop("portrait", torch.tensor(False)))
        d = self.cfg.data
        out_hw = (d.pad_w, d.pad_h) if portrait and d.pad_h != d.pad_w else (d.pad_h, d.pad_w)
        tb = batch_transform(
            batch["raw"], batch["hw"], batch["flip"], batch["gt_boxes"], out_hw=out_hw,
            scale_size=d.scale, max_size=d.max_size, mean=d.mean, std=d.std,
            dtype=self.model.compute_dtype, scale_sizes=batch.get("scale_size"))
        tb["gt_labels"] = batch["gt_labels"]
        tb["gt_valid"] = batch["gt_valid"].bool()
        return sanitize_gt(tb)

    def run_step(self, batch: dict, draws: Draws | None = None) -> dict:
        """One update from a raw batch: raw (B, h, w, 3) uint8, hw (B, 2),
        flip (B,), gt_boxes (B, G, 4), gt_labels (B, G), gt_valid (B, G),
        optionally portrait and scale_size (B,). Returns the metrics as 0-d
        tensors on the device (no host sync): the loss terms, ``loss`` and
        ``grad_norm``, the global gradient norm before clipping."""
        draws = self.draws if draws is None else draws
        tb = self.device_batch(batch)
        for p in self.params:
            p.grad = None
        outputs = self.model.forward_train(tb, draws)
        loss, metrics = rcnn_loss(outputs, tb, draws, self.cfg)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = self.optimizer.step([p.grad for p in self.params])
        return metrics
