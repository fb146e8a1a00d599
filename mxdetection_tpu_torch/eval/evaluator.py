"""Inference/eval loop: batched forward + postprocess on the model's device
-> COCO metrics or VOC mAP — port of ``mxdetection_tpu.eval.evaluator``.

Each batch runs eagerly on the device: ``batch_transform`` ->
``forward_test`` -> the detector's postprocess (``detector_fns``) and, for
a mask head, ``mask_probs``; only the fixed-size top detections of each image
come to the host. Flip and multi-scale TTA run every variant, merge their
boxes with the configured test NMS (``merge_tta``) and re-run the mask head
on the merged boxes against every variant's kept pyramid (``tta_masks``).
Masks are pasted into the image by ``paste_masks`` (Pillow's bilinear resize
in its fixed point, on the device) and RLE-encoded on the host
(``rle_native`` when it builds). ``run`` times the steady state without the
first batch, which also pays the card's first kernel loads, and reports the
forward's seconds and the host's paste + RLE seconds apart.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..data.coco import CocoDataset, rasterize_full_mask
from ..data.images import bilinear_pass
from ..data.loader import DetectionLoader
from ..data.transforms import batch_transform
from ..models.detectors.rcnn import mask_probs
from ..models.registry import detector_fns
from ..ops import boxes as box_lib
from ..ops import nms as nms_lib
from ..parallel.dist import all_gather_objects
from . import rle_native
from .coco_eval import CocoEvaluator, format_table
from .rle import encode_rle


def encode(mask: np.ndarray) -> dict:
    """RLE of a (H, W) bool mask by the native codec where it builds, else numpy."""
    return rle_native.encode(mask) if rle_native.available() else encode_rle(mask)


def build_gt_list(ds: CocoDataset, with_masks: bool = False) -> list:
    gts = []
    for rec in ds.records:
        for i in range(len(rec.boxes)):
            b = rec.boxes[i]
            gt = {
                "image_id": rec.image_id,
                "category": int(rec.labels[i]),
                "bbox": [float(x) for x in b],
                "area": float(rec.areas[i]) if rec.areas is not None
                else float((b[2] - b[0]) * (b[3] - b[1])),
                "iscrowd": bool(rec.is_crowd[i]),
            }
            if with_masks:
                gt["mask"] = encode(rasterize_full_mask(rec.polygons[i], rec.height, rec.width))
            gts.append(gt)
    return gts


def paste_masks(masks: torch.Tensor, boxes: np.ndarray, im_h: int, im_w: int,
                thr: float = 0.5) -> list:
    """Paste D box-normalised mask probabilities (D, M, M) into the image,
    as the JAX evaluator's ``paste_mask`` does with Pillow: each mask becomes
    uint8 (``mask*255`` truncated), is resized to its box's rounded size by
    Pillow's BILINEAR resize (``data/images.py::bilinear_pass``, batched over
    the D masks on their device), and its pixels with value/255 >=
    ``thr`` are set. ``boxes`` (D, 4) float32 on the host, image coordinates.
    Returns D (im_h, im_w) bool arrays."""
    d = len(boxes)
    if d == 0:
        return []
    x1, y1, x2, y2 = (boxes[:, k] for k in range(4))
    ws = [max(int(round(v)), 1) for v in x2 - x1]
    hs = [max(int(round(v)), 1) for v in y2 - y1]
    m8 = (masks.float() * 255).to(torch.uint8).int()
    # a pass that shrinks sums up to 2M/size + 1 taps, one that grows 3:
    # masks are resized in groups by shrinking or not along each axis, so a
    # tiny box does not make every mask of the batch take its taps
    size = masks.shape[-1]
    keep = [None] * d
    for group in {(w < size, h < size) for w, h in zip(ws, hs)}:
        sel = [i for i in range(d) if (ws[i] < size, hs[i] < size) == group]
        g = bilinear_pass(m8[sel], 2, [ws[i] for i in sel])  # Pillow: horizontal first
        g = bilinear_pass(g, 1, [hs[i] for i in sel])
        for i, k in zip(sel, ((g.float() / 255.0) >= thr).cpu().numpy()):
            keep[i] = k
    out = []
    for i in range(d):
        canvas = np.zeros((im_h, im_w), bool)
        x0, y0 = int(round(x1[i])), int(round(y1[i]))
        xs, ys = max(0, -x0), max(0, -y0)
        xe = min(ws[i], im_w - x0)
        ye = min(hs[i], im_h - y0)
        if xe > xs and ye > ys:
            canvas[y0 + ys:y0 + ye, x0 + xs:x0 + xe] = keep[i][ys:ye, xs:xe]
        out.append(canvas)
    return out


class Evaluator:
    """Runs a detector over a dataset and computes COCO metrics (or VOC mAP
    when ``protocol="voc"``). ``model`` is a ``build_detector`` model in eval
    mode on its device; batches go there. After ``run``, ``records`` holds
    each image's detections (image_id, boxes, scores, labels and, for segm,
    rles) and ``timing`` the steady state's split."""

    def __init__(self, cfg: Config, model: torch.nn.Module, dataset: CocoDataset,
                 batch_size: int = 8, raw_hw=(640, 640), with_masks: bool = False,
                 protocol: str = "coco"):
        self.protocol = protocol
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.ds = dataset
        self.with_masks = with_masks
        self.loader = DetectionLoader(
            dataset, batch_size=batch_size, raw_hw=raw_hw, max_gt=cfg.data.max_gt,
            shuffle=False, flip=False, drop_last=False, orient_buckets=True)
        self.postprocess = detector_fns(cfg).postprocess
        d = cfg.data
        # TTA variants: (scale_size, flip)
        self.tta_variants = [(d.scale, False)]
        for s in cfg.test.scales_tta:
            if s != d.scale:
                self.tta_variants.append((int(s), False))
        if cfg.test.flip_tta:
            self.tta_variants += [(s, True) for (s, _) in list(self.tta_variants)]
        self._want_masks = with_masks and cfg.mask_head is not None
        self.records: list = []
        self.timing: dict = {}

    @torch.no_grad()
    def forward(self, batch: dict, scale_size: int, flip: bool = False, out_hw=None,
                want_masks: bool = False, keep_pyramid: bool = False) -> dict:
        """One variant of a device batch -> detections (B, max_per_image) on the device."""
        d = self.cfg.data
        flips = torch.ones_like(batch["flip"]) if flip else batch["flip"]
        tb = batch_transform(
            batch["raw"], batch["hw"], flips, batch["gt_boxes"], out_hw=out_hw,
            scale_size=scale_size, max_size=d.max_size, mean=d.mean, std=d.std,
            dtype=self.model.compute_dtype)
        out = self.model.forward_test(tb["images"], tb["im_info"])
        dets = self.postprocess(out, self.cfg, out_hw, tb["im_info"])
        if want_masks:
            dets["masks"] = mask_probs(self.model, out, dets, tb["im_info"])
        if keep_pyramid:
            dets["pyramid"] = out["pyramid"]
            dets["scale"] = tb["im_info"][:, 2]
        return dets

    @torch.no_grad()
    def merge_tta(self, det_list: list, im_w: torch.Tensor) -> dict:
        """Merge per-variant detections: unflip, concatenate, then the full
        test-time NMS dispatch (greedy or Soft-NMS, box voting) of the config."""
        parts = {"boxes": [], "scores": [], "labels": [], "valid": []}
        for (_, flip), dets in zip(self.tta_variants, det_list):
            b = dets["boxes"]
            parts["boxes"].append(box_lib.flip_boxes(b, im_w[:, None]) if flip else b)
            for k in ("scores", "labels", "valid"):
                parts[k].append(dets[k])
        merged = {k: torch.cat(v, dim=1) for k, v in parts.items()}
        b, s, lab, v = nms_lib.class_aware_nms_from_cfg(
            self.cfg.test, merged["boxes"], merged["scores"], merged["labels"],
            valid=merged["valid"])
        return {"boxes": b, "scores": s, "labels": lab, "valid": v}

    @torch.no_grad()
    def tta_masks(self, pyramids: list, scales: list, boxes: torch.Tensor,
                  valid: torch.Tensor, labels: torch.Tensor, im_w: torch.Tensor) -> torch.Tensor:
        """Mask merging for TTA: the mask head re-runs on the merged boxes
        against every variant's kept pyramid (boxes mapped into the variant's
        resized, flipped frame; its masks unflipped), and the probabilities
        are averaged over the variants."""
        probs = None
        num_classes = self.cfg.bbox_head.num_classes
        for (_, flip), pyr, scale in zip(self.tta_variants, pyramids, scales):
            bx = box_lib.flip_boxes(boxes, im_w[:, None]) if flip else boxes
            logits = self.model.mask_forward(pyr, bx * scale[:, None, None], valid)
            b, n, ms = logits.shape[:3]
            cls_idx = labels.long().clamp(0, num_classes - 1)
            sel = torch.gather(logits, -1, cls_idx[..., None, None, None].expand(b, n, ms, ms, 1))
            p = torch.sigmoid(sel[..., 0])
            if flip:
                p = torch.flip(p, dims=(-1,))  # masks are (y, x) in the box's frame
            probs = p if probs is None else probs + p
        return probs / float(len(self.tta_variants))

    def _detect(self, batch: dict, out_hw) -> dict:
        if len(self.tta_variants) == 1:
            return self.forward(batch, self.cfg.data.scale, out_hw=out_hw,
                                want_masks=self._want_masks)
        # each variant runs the backbone and the box path; masks are
        # recomputed on the merged boxes from the kept pyramids
        per_variant = [self.forward(batch, s, flip=f, out_hw=out_hw,
                                    keep_pyramid=self._want_masks)
                       for (s, f) in self.tta_variants]
        im_w = batch["hw"][:, 1]
        merged = self.merge_tta(per_variant, im_w)
        if self._want_masks:
            merged["masks"] = self.tta_masks(
                [dv["pyramid"] for dv in per_variant], [dv["scale"] for dv in per_variant],
                merged["boxes"], merged["valid"], merged["labels"], im_w)
        return merged

    def run(self, max_images: int | None = None, verbose: bool = True) -> dict:
        evaluator = segm_eval = None
        if self.protocol == "coco":
            evaluator = CocoEvaluator(build_gt_list(self.ds), self.ds.num_classes, "bbox")
            if self.with_masks:
                segm_eval = CocoEvaluator(build_gt_list(self.ds, with_masks=True),
                                          self.ds.num_classes, "segm")
        size_by_id = {r.image_id: (r.height, r.width) for r in self.ds.records}

        n_done = 0
        seen: set = set()
        records: list = []  # per-image host records, merged across processes
        d = self.cfg.data
        # steady state: the first batch also pays the first kernel loads, so
        # the clock restarts after it
        t0 = time.perf_counter()
        n_at_t0 = n_batches = 0
        forward_s = paste_rle_s = 0.0
        for batch in self.loader.epoch(0):
            tb0 = time.perf_counter()
            portrait = bool(batch.pop("portrait", False))
            out_hw = (d.pad_w, d.pad_h) if portrait else (d.pad_h, d.pad_w)
            dev_batch = {k: torch.from_numpy(batch[k]).to(self.device)
                         for k in ("raw", "hw", "flip", "gt_boxes")}
            out = self._detect(dev_batch, out_hw)
            dets = {k: out[k].cpu().numpy() for k in ("boxes", "scores", "labels", "valid")}
            tb1 = time.perf_counter()
            for i in range(len(batch["image_ids"])):
                if max_images is not None and n_done >= max_images:
                    break
                img_id = int(batch["image_ids"][i])
                if img_id in seen:  # wrap-around fill of partial batches
                    continue
                seen.add(img_id)
                v = dets["valid"][i]
                rec = {"image_id": img_id, "boxes": dets["boxes"][i][v],
                       "scores": dets["scores"][i][v], "labels": dets["labels"][i][v],
                       "rles": None}
                if segm_eval is not None:
                    im_h, im_w = size_by_id[img_id]
                    masks = out["masks"][i][torch.from_numpy(v).to(self.device)]
                    rec["rles"] = [encode(m) for m in
                                   paste_masks(masks, rec["boxes"], im_h, im_w)]
                records.append(rec)
                n_done += 1
            n_batches += 1
            if n_batches == 1:
                t0 = time.perf_counter()
                n_at_t0 = n_done
            else:
                forward_s += tb1 - tb0
                paste_rle_s += time.perf_counter() - tb1
            if max_images is not None and n_done >= max_images:
                break
        dt = time.perf_counter() - t0
        n_timed = n_done - n_at_t0  # 0 if the whole eval fit in one batch

        # distributed merge: wrap-fill can repeat an image across processes,
        # so dedup by image_id (the first wins; the detections are the same)
        merged_seen: set = set()
        self.records = []
        for rec in (r for part in all_gather_objects(records) for r in part):
            if rec["image_id"] in merged_seen:
                continue
            merged_seen.add(rec["image_id"])
            self.records.append(rec)
            if self.protocol == "voc":
                continue
            evaluator.add(rec["image_id"], rec["boxes"], rec["scores"], rec["labels"])
            if segm_eval is not None:
                segm_eval.add(rec["image_id"], rec["boxes"], rec["scores"], rec["labels"],
                              masks=rec["rles"])
        if self.protocol == "voc":
            from ..data.voc import evaluate_voc

            results = evaluate_voc(self.records, self.ds,
                                   use_07_metric=self.cfg.data.voc_metric_07)
            results["AP50"] = results["mAP"]  # common key for the tools
        else:
            results = evaluator.evaluate()
        results["images_per_sec"] = n_timed / max(dt, 1e-9)
        results["num_images"] = len(self.records)
        if segm_eval is not None:
            results["segm"] = segm_eval.evaluate()
        self.timing = {"timed_batches": max(n_batches - 1, 0), "timed_images": n_timed,
                       "seconds": dt, "forward_s": forward_s, "paste_rle_s": paste_rle_s,
                       "rle": rle_native.implementation(),
                       "matcher": evaluator.matcher if evaluator is not None else None}
        if verbose:
            if self.protocol == "voc":
                print(f"VOC mAP@0.5 = {results['mAP']:.4f} "
                      f"({'11-point' if self.cfg.data.voc_metric_07 else 'area'})")
            else:
                print(format_table(results))
            if segm_eval is not None:
                print("segm:")
                print(format_table(results["segm"], "segm"))
            print(f"inference: {n_done} imgs total, {n_timed} post-warmup in {dt:.1f}s "
                  f"({results['images_per_sec']:.2f} img/s steady-state; forward "
                  f"{forward_s:.2f} s, paste + RLE {paste_rle_s:.2f} s; RLE codec "
                  f"{self.timing['rle']}, matcher {self.timing['matcher']})")
        return results
