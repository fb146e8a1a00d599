"""One data-parallel training step — port of ``mxdetection_tpu.train.trainer``.

``Trainer.run_step`` does what the JAX package's jitted ``shard_map`` step
does, eagerly, on each replica (one process per device): raw uint8 batch ->
``batch_transform`` (on the canvas of the batch's orientation) ->
``sanitize_gt`` -> ``forward_train`` -> the detector's loss
(``models/registry.py::detector_fns``: ``rcnn_loss`` for the R-CNN family
and R-FCN, ``retinanet_loss`` for RetinaNet) -> backward -> the
gradients, metrics and loss averaged over the replicas -> the optimizer
update. The optimizer is written out to match the optax chain
``clip_by_global_norm -> add_decayed_weights -> sgd(momentum)``
(``make_optimizer``): torch's ``clip_grad_norm_`` divides by ``norm + 1e-6``
and ``torch.optim.SGD`` decays and steps in another order.

The replicas are the ``torch.distributed`` process group
(``parallel/mesh.py``); without one the step is single-device. The average
is one ``all_reduce`` of a flat f32 buffer, not ``DistributedDataParallel``:
with ``frozen_stages >= 0`` the frozen stem and stages get no gradient,
which DDP takes only with ``find_unused_parameters``, and the JAX step
reduces after the whole backward too. Checkpoints are ``checkpoint.py``;
``fit_epochs`` runs the steps over a ``data.loader.DetectionLoader``'s epochs
and logs every ``log_every``-th step (to the logger and a JSONL file).
"""

from __future__ import annotations

import json
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.transforms import batch_transform
from ..models.registry import build_detector, detector_fns, require_device
from ..ops.matching import Draws, TorchDraws
from ..parallel.mesh import data_parallel_size, world_size
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
    """Data-parallel trainer of any detector of the zoo (Faster, Mask or
    Cascade R-CNN, R-FCN, RetinaNet; ``build_detector(train=True)``), one
    replica per process.

    ``model=None`` builds one from ``cfg`` on ``device`` with seeded
    weights (``seed``); a given model is moved to ``device``. The device is
    the card unless the caller asks for the CPU. In a process group of more
    than one replica (``parallel.mesh.initialize_multihost``), rank 0's
    parameters and buffers are broadcast at construction, and
    ``cfg.train.mesh_shape`` must resolve to the group's size. The samplers'
    random draws come from a ``torch.Generator`` on the device seeded with
    ``cfg.train.seed`` on every rank, as every replica of the JAX step draws
    from the one replicated key, unless ``run_step`` is handed another source.
    """

    def __init__(self, cfg: Config, model: torch.nn.Module | None = None, *,
                 steps_per_epoch: int = 1, device="cuda", seed: int | None = 0,
                 logger=None):
        self.cfg = cfg
        self.logger = logger
        self.device = require_device(device)
        if model is None:
            model = build_detector(cfg, device=self.device, seed=seed, train=True)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.replicas = data_parallel_size(cfg.train.mesh_shape)
        if self.replicas > 1:
            with torch.no_grad():
                for t in [*self.params, *self.model.buffers()]:
                    dist.broadcast(t, src=0)
        self.optimizer, self.lr_fn = make_optimizer(cfg, self.params, steps_per_epoch)
        self.loss_fn = detector_fns(cfg).loss
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
        if "box_masks" in batch:  # already mirrored for flipped images by the loader
            tb["box_masks"] = batch["box_masks"]
        return sanitize_gt(tb)

    def run_step(self, batch: dict, draws: Draws | None = None) -> dict:
        """One update from this replica's rows of the global batch: raw
        (B, h, w, 3) uint8, hw (B, 2), flip (B,), gt_boxes (B, G, 4),
        gt_labels (B, G), gt_valid (B, G), for Mask R-CNN box_masks
        (B, G, M, M) uint8 (each gt's mask in its box's frame, mirrored for
        a flipped image), optionally portrait and scale_size (B,); every
        replica holds the same B. Returns the metrics
        averaged over the replicas as 0-d tensors on the device (no host
        sync on one replica): the loss terms, ``loss`` and ``grad_norm``,
        the global norm of the averaged gradient before clipping."""
        draws = self.draws if draws is None else draws
        if self.replicas > 1:
            self._check_equal_local_batches(len(batch["raw"]))
        tb = self.device_batch(batch)
        for p in self.params:
            p.grad = None
        outputs = self.model.forward_train(tb, draws)
        loss, metrics = self.loss_fn(outputs, tb, draws, self.cfg)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        grads = [p.grad for p in self.params]
        if self.replicas > 1:
            grads, metrics = self._average(grads, metrics)
        metrics["grad_norm"] = self.optimizer.step(grads)
        return metrics

    def _check_equal_local_batches(self, b: int) -> None:
        """SyncBN's average and the gradients' are unweighted means over the
        replicas, as ``pmean``: they need equal local batches."""
        t = torch.tensor([b, -b], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        if int(t[0]) != -int(t[1]):
            raise ValueError(f"local batches of {-int(t[1])} to {int(t[0])} images: "
                             "every replica must hold the same number")

    def _average(self, grads: list, metrics: dict) -> tuple:
        """The JAX step's ``pmean(grads)``, ``pmean(metrics)``, ``pmean(loss)``
        in one all-reduce (sum, then divide: gloo has no average) of a flat
        f32 buffer; a parameter without a gradient contributes zeros."""
        parts = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        names = sorted(metrics)
        flat = torch.cat([t.reshape(-1).float() for t in parts]
                         + [torch.stack([metrics[k].float() for k in names])])
        dist.all_reduce(flat)
        flat /= self.replicas
        out, i = [], 0
        for p in self.params:
            out.append(flat[i:i + p.numel()].view_as(p))
            i += p.numel()
        return out, dict(zip(names, flat[i:].unbind()))

    def fit_epochs(self, loader, num_epochs: int, log_every: int = 20, on_metrics=None,
                   metrics_file: str | None = None) -> list:
        """Run ``num_epochs`` epochs of ``loader`` (``epoch(n)`` yields numpy
        batches); returns the logged metric dicts. Every ``log_every``-th step
        (by the optimizer's count) the metrics become floats (the one host
        sync of a logged step), with step, epoch, lr (the schedule at the
        step) and imgs_per_sec since the last log over the global batch; each
        is logged, appended to ``metrics_file`` as one JSON line and passed to
        ``on_metrics``."""
        history = []
        global_bs = loader.batch_size * world_size()
        t0 = time.perf_counter()
        n_since = 0
        for epoch in range(num_epochs):
            for batch in loader.epoch(epoch):
                metrics = self.run_step(batch)
                n_since += 1
                step = self.optimizer.count
                if step % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    m.update(step=step, epoch=epoch, lr=float(self.lr_fn(step)),
                             imgs_per_sec=global_bs * n_since / max(dt, 1e-9))
                    t0, n_since = time.perf_counter(), 0
                    history.append(m)
                    if self.logger:
                        self.logger.info("step %d ep %d loss %.4f lr %.5f %.1f img/s", step,
                                         epoch, m["loss"], m["lr"], m["imgs_per_sec"])
                    if metrics_file:
                        with open(metrics_file, "a") as fh:
                            fh.write(json.dumps(m) + "\n")
                    if on_metrics:
                        on_metrics(m)
        return history
