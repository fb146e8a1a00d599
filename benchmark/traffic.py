"""The one traffic generator: a pool of distinct seeded images (and, for
training, their gt boxes), laid out in pinned host memory in the order the
batches take them.

A traffic file (``benchmark/traffic/<name>.json``) gives its parameters:
``mode`` (infer | train), ``batch``, ``in_flight`` (inference batches
submitted before the oldest is collected), ``pool`` (distinct images),
``canvas`` ([h, w] of the uint8 canvas each image sits in, top-left),
``sizes`` ([[h, w, weight], ...]: the images' sizes and their shares),
``orientation_buckets`` (train: every batch of one orientation, as the
loader buckets them), ``flip_prob``, and ``gt`` (train: ``min``, ``max``
and ``mean`` boxes an image, ``classes``, ``area_shares`` of small,
medium and large boxes by COCO's 32^2 / 96^2 cuts, ``max_gt`` the padded
rows), ``follow_window_steps`` (train: [lo, hi], the range of the window's
step, counted from 0 and drawn from the seed, from which the reference
follows three steps; the window runs at least to the third). Every seed gets the same multiset of sizes, box counts and area
classes, in another order, so that a seed changes which images a batch
holds and not how much work it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AREA_RANGES = ((8.0, 32.0), (32.0, 96.0), (96.0, 400.0))  # sqrt(area) px of each COCO class


def _shares(n: int, weights) -> list:
    """Largest-remainder split of ``n`` items by ``weights``."""
    w = np.asarray(weights, float) / sum(weights)
    base = np.floor(w * n).astype(int)
    for i in np.argsort(-(w * n - base))[: n - base.sum()]:
        base[i] += 1
    return base.tolist()


def _box_counts(n: int, g: dict) -> np.ndarray:
    """The same multiset every seed: counts from ``min`` to ``max`` whose
    mean is ``mean``, spread as a geometric tail above ``min``."""
    lo, hi, mean = g["min"], g["max"], g["mean"]
    ks = np.arange(lo, hi + 1)
    lo_r, hi_r = 1e-3, 1e3
    for _ in range(100):  # solve the tail ratio for the mean
        r = math.sqrt(lo_r * hi_r)
        p = r ** (ks - lo)
        if (p * ks).sum() / p.sum() > mean:
            hi_r = r
        else:
            lo_r = r
    counts = np.repeat(ks, _shares(n, p))
    return counts


class Pool:
    """The traffic of one run: ``batch(k)`` is batch k of the closed loop
    (pinned host tensors), cycling over the pool."""

    def __init__(self, t: dict, seed: int, device, pin: bool = True):
        self.t = t
        rng = np.random.default_rng(int(seed))
        n, (ch, cw), b = t["pool"], t["canvas"], t["batch"]
        if n % b:
            raise ValueError(f"a pool of {n} images does not split into batches of {b}")
        sizes = []
        for (h, w, _), k in zip(t["sizes"], _shares(n, [s[2] for s in t["sizes"]])):
            sizes += [(h, w)] * k
        sizes = np.asarray(sizes, np.float32)
        if t.get("orientation_buckets"):
            order = self._bucket_order(sizes, b, rng)
        else:
            order = rng.permutation(n)
        sizes = sizes[order]
        self.hw = torch.from_numpy(sizes)
        self.portrait = torch.from_numpy(sizes[:, 0] > sizes[:, 1])
        self.flip = torch.from_numpy(rng.random(n) < t.get("flip_prob", 0.0))
        g = t.get("gt")
        gmax = g["max_gt"] if g else 1
        boxes = np.zeros((n, gmax, 4), np.float32)
        labels = np.zeros((n, gmax), np.int32)
        valid = np.zeros((n, gmax), bool)
        if g:
            counts = rng.permutation(_box_counts(n, g))
            areas = rng.permutation(np.repeat(np.arange(3), _shares(int(counts.sum()), g["area_shares"])))
            a = 0
            for i in range(n):
                h, w = sizes[i]
                for j in range(counts[i]):
                    lo, hi = AREA_RANGES[areas[a]]
                    a += 1
                    side = math.exp(rng.uniform(math.log(lo), math.log(hi)))
                    ar = math.exp(rng.normal(0.0, 0.5))
                    bw, bh = min(side * math.sqrt(ar), w - 1), min(side / math.sqrt(ar), h - 1)
                    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                    boxes[i, j] = (x0, y0, x0 + bw, y0 + bh)
                    labels[i, j] = rng.integers(0, g["classes"])
                    valid[i, j] = True
        self.gt_boxes, self.gt_labels = torch.from_numpy(boxes), torch.from_numpy(labels)
        self.gt_valid = torch.from_numpy(valid)
        self.raw = self._images(n, ch, cw, sizes, boxes, valid, rng, device).cpu()
        if pin:
            for k in ("raw", "hw", "flip", "gt_boxes", "gt_labels", "gt_valid"):
                setattr(self, k, getattr(self, k).pin_memory())
        self.n_batches = n // b

    @staticmethod
    def _bucket_order(sizes, b: int, rng) -> np.ndarray:
        """Batches of one orientation; the cycle's first batch landscape and
        its second portrait (where the pool has both), so that the set-up's
        first steps meet both canvases."""
        port = np.flatnonzero(sizes[:, 0] > sizes[:, 1])
        land = np.flatnonzero(sizes[:, 0] <= sizes[:, 1])
        if len(port) % b or len(land) % b:
            raise ValueError("each orientation must fill whole batches")
        land, port = rng.permutation(land), rng.permutation(port)
        lb = [land[i:i + b] for i in range(0, len(land), b)]
        pb = [port[i:i + b] for i in range(0, len(port), b)]
        head = [lb.pop(0)] + ([pb.pop(0)] if pb else [])
        rest = lb + pb
        rest = [rest[i] for i in rng.permutation(len(rest))]
        return np.concatenate(head + rest)

    @staticmethod
    def _images(n, ch, cw, sizes, boxes, valid, rng, device) -> torch.Tensor:
        """uint8 (n, ch, cw, 3) on ``device``: a smooth random field with
        texture, the gt boxes (train) or as many random boxes (infer) filled
        with flat colours, zero outside each image's (h, w)."""
        gen = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2 ** 62)))
        coarse = torch.rand((n, 3, 12, 12), generator=gen, device=device) * 200 + 28
        img = torch.nn.functional.interpolate(coarse, size=(ch, cw), mode="bilinear",
                                              align_corners=False)
        img = img + torch.randn((n, 3, ch, cw), generator=gen, device=device) * 12
        img = img.permute(0, 2, 3, 1).clamp(0, 255).to(torch.uint8).contiguous()
        for i in range(n):
            h, w = int(sizes[i, 0]), int(sizes[i, 1])
            rows = boxes[i][valid[i]] if valid[i].any() else None
            if rows is None:
                k = int(rng.integers(3, 12))
                x0, y0 = rng.uniform(0, w - 40, k), rng.uniform(0, h - 40, k)
                rows = np.stack([x0, y0, x0 + rng.uniform(16, w / 2, k), y0 + rng.uniform(16, h / 2, k)], 1)
            for x0, y0, x1, y1 in rows:
                colour = torch.from_numpy(rng.integers(0, 256, 3).astype(np.uint8)).to(device)
                img[i, int(y0):int(math.ceil(min(y1, h))), int(x0):int(math.ceil(min(x1, w)))] = colour
            img[i, h:] = 0
            img[i, :, w:] = 0
        return img

    def rows(self, k: int) -> slice:
        b = self.t["batch"]
        s = (k % self.n_batches) * b
        return slice(s, s + b)

    def infer_batch(self, k: int) -> tuple:
        r = self.rows(k)
        return self.raw[r], self.hw[r]

    def train_batch(self, k: int) -> dict:
        """The training batch as a loader delivers it: host tensors."""
        r = self.rows(k)
        return {"raw": self.raw[r], "hw": self.hw[r], "flip": self.flip[r],
                "gt_boxes": self.gt_boxes[r], "gt_labels": self.gt_labels[r],
                "gt_valid": self.gt_valid[r], "portrait": bool(self.portrait[r][0])}
