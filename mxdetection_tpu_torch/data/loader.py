"""Host data loader: decode-only workers feeding fixed-shape uint8 batches —
port of ``mxdetection_tpu.data.loader``.

The host does only the image decode and its placement into a fixed raw
canvas; resize, normalise, flip and the targets run on the device
(``transforms.batch_transform``, ``Trainer.device_batch``). Decode runs on a
small thread pool behind a bounded prefetch queue; batches stay numpy and
the consumer moves them to its device.

Sharding: the batch plan (shuffle order, flip and scale draws, orientation
buckets, wrap-around fill) is built from the GLOBAL index set identically on
every process, then each global batch is strided across the shards, so every
process agrees on the step count and each step's canvas orientation. The
shards are the ``torch.distributed`` group's ranks when one exists.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch.distributed as dist

from .coco import CocoDataset
from .images import resize_bilinear_u8


class DetectionLoader:
    """Yields dict batches of fixed-shape numpy arrays.

    Keys: raw (B, raw_h, raw_w, 3) u8; hw (B, 2) f32; flip (B,) bool;
    gt_boxes (B, G, 4) f32 (original image coords); gt_labels (B, G) i32;
    gt_valid (B, G) bool; image_ids (B,) i64; and box_masks (B, G, M, M) u8
    when the dataset carries masks.
    """

    def __init__(self, dataset: CocoDataset, *, batch_size: int,
                 raw_hw: tuple[int, int] = (640, 640), max_gt: int = 100,
                 shuffle: bool = True, flip: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 4,
                 num_shards: int | None = None, shard_index: int | None = None,
                 with_masks: bool = False, drop_last: bool = True,
                 train_scales: tuple = (), orient_buckets: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.raw_hw = raw_hw
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.flip = flip
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.with_masks = with_masks
        self.drop_last = drop_last
        self.train_scales = tuple(train_scales)
        self.orient_buckets = orient_buckets

        group = dist.is_available() and dist.is_initialized()
        if num_shards is None:
            num_shards = dist.get_world_size() if group else 1
        if shard_index is None:
            shard_index = dist.get_rank() if group else 0
        self.num_shards = num_shards
        self.shard_index = shard_index
        # one global batch = batch_size rows on each of num_shards processes
        self.global_batch = batch_size * num_shards
        self.all_indices = np.arange(len(dataset))
        # nominal shard (dataset-coverage accounting; the per-epoch assignment
        # comes from striding the globally-planned batches)
        self.indices = self.all_indices[shard_index::num_shards]
        if len(self.indices) == 0:
            raise ValueError("empty shard")

    def steps_per_epoch(self) -> int:
        """Global step count — identical on every process by construction."""
        if self.orient_buckets:
            port = self._portrait_mask(self.all_indices)
            return (self._group_batches(int(port.sum()))
                    + self._group_batches(int((~port).sum())))
        return self._group_batches(len(self.all_indices))

    def _group_batches(self, n: int) -> int:
        if n == 0:
            return 0
        return n // self.global_batch if self.drop_last else -(-n // self.global_batch)

    def _portrait_mask(self, idx: np.ndarray) -> np.ndarray:
        """True where the record is taller than wide (h > w)."""
        recs = self.ds.records
        return np.asarray([recs[int(i)].height > recs[int(i)].width for i in idx])

    def _load_one(self, rec_idx: int, flip: bool) -> dict:
        rec = self.ds.records[rec_idx]
        img = self.ds.load_image(rec)
        rh, rw = self.raw_hw
        h, w = img.shape[:2]
        if h > rh or w > rw:
            # static raw canvas contract: pre-shrink rare oversize images
            s = min(rh / h, rw / w)
            img = resize_bilinear_u8(img, int(h * s), int(w * s))  # Pillow's BILINEAR
            h, w = img.shape[:2]
            boxes = rec.boxes * s
        else:
            boxes = rec.boxes
        raw = np.zeros((rh, rw, 3), np.uint8)
        raw[:h, :w] = img

        g = self.max_gt
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_labels = np.zeros((g,), np.int32)
        gt_valid = np.zeros((g,), bool)
        n = min(len(boxes), g)
        # crowd boxes are excluded from training targets (family convention)
        keep = ~rec.is_crowd
        kept_boxes = boxes[keep][:g]
        kept_labels = rec.labels[keep][:g]
        n = len(kept_boxes)
        gt_boxes[:n] = kept_boxes
        gt_labels[:n] = kept_labels
        gt_valid[:n] = True

        out = {
            "raw": raw,
            "hw": np.asarray([h, w], np.float32),
            "flip": np.asarray(flip),
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_valid": gt_valid,
            "image_id": np.asarray(rec.image_id, np.int64),
        }
        if self.with_masks:
            m = self.ds.box_mask_size
            bm = np.zeros((g, m, m), np.uint8)
            masks = self.ds.get_box_masks(rec)[keep][:g]
            # box_masks live in the gt-box frame; a horizontal image flip
            # mirrors each box's content, so the canonical masks must mirror
            # too (the device-side flip only moves the box, never its mask).
            bm[:n] = masks[:, :, ::-1] if flip else masks
            out["box_masks"] = bm
        return out

    def _batch_plan(self, epoch: int) -> list[dict]:
        """Deterministic list of this shard's batch specs for one epoch.

        Each spec: idx (B,), flip (B,), portrait bool, scale_size (B,)|None.
        The plan is built over the GLOBAL index set with the global batch size
        (every process runs this identical computation from the shared seed),
        then each global batch is strided ``[shard_index::num_shards]`` — so
        all processes agree on step count, per-step orientation, and per-step
        program choice. With ``orient_buckets`` batches are homogeneous in
        orientation (portrait canvas is the transposed landscape canvas), so
        mixed datasets need two canvas shapes instead of truncating portrait
        content.
        """
        rng = np.random.RandomState(self.seed + epoch)
        order = self.all_indices.copy()
        if self.shuffle:
            rng.shuffle(order)
        flips = rng.rand(len(order)) < 0.5 if self.flip else np.zeros(len(order), bool)
        if self.train_scales:
            scale_choices = rng.choice(
                self.train_scales, size=len(order)).astype(np.float32)
        else:
            scale_choices = None

        def group_specs(sel: np.ndarray, portrait: bool) -> list[dict]:
            g_order, g_flips = order[sel], flips[sel]
            g_scales = scale_choices[sel] if scale_choices is not None else None
            specs = []
            for b in range(self._group_batches(len(g_order))):
                sl = slice(b * self.global_batch, (b + 1) * self.global_batch)
                idx, fl = g_order[sl], g_flips[sl]
                sc = g_scales[sl] if g_scales is not None else None
                if len(idx) < self.global_batch:
                    # tiled wrap-around fill: always yields a FULL batch even
                    # when the whole group is smaller than one global batch
                    extra = self.global_batch - len(idx)
                    idx = np.concatenate([idx, np.resize(g_order, extra)])
                    fl = np.concatenate([fl, np.resize(g_flips, extra)])
                    if sc is not None:
                        sc = np.concatenate([sc, np.resize(g_scales, extra)])
                shard = slice(self.shard_index, None, self.num_shards)
                specs.append({"idx": idx[shard], "flip": fl[shard],
                              "portrait": portrait,
                              "scale_size": sc[shard] if sc is not None else None})
            return specs

        if self.orient_buckets:
            port = self._portrait_mask(order)
            specs = group_specs(~port, False) + group_specs(port, True)
            if self.shuffle:
                rng.shuffle(specs)
            return specs
        return group_specs(np.ones(len(order), bool), False)

    def epoch(self, epoch: int) -> Iterator[dict]:
        """One pass over this shard, prefetched. Deterministic per (seed, epoch).

        Decode runs on a ``num_workers`` thread pool (file reads and Pillow's
        JPEG decode release the GIL); batches are assembled and yielded in
        deterministic order.
        """
        specs = self._batch_plan(epoch)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def assemble(spec: dict, pool) -> dict:
            futs = [pool.submit(self._load_one, int(i), bool(f))
                    for i, f in zip(spec["idx"], spec["flip"])]
            samples = [f.result() for f in futs]
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            batch["image_ids"] = batch.pop("image_id")
            batch["portrait"] = spec["portrait"]
            if spec["scale_size"] is not None:
                batch["scale_size"] = spec["scale_size"]
            return batch

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
                    for spec in specs:
                        if stop.is_set():
                            return
                        q.put(assemble(spec, pool))
            except Exception as err:  # a failed decode: the consumer raises it
                q.put(err)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early: let a producer blocked on the full
            # queue finish its batch and see the stop
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()

    def __iter__(self):
        ep = 0
        while True:
            yield from self.epoch(ep)
            ep += 1
