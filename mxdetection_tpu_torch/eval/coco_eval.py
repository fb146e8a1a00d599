"""COCO-protocol detection evaluation in numpy — port of
``mxdetection_tpu.eval.coco_eval`` (the same protocol and code; the JAX
package's ``eval`` package imports jax, so the port keeps its own copy).

An independent implementation of the published COCOeval algorithm: greedy
score-ordered matching per (image, category) at IoU 0.5:0.05:0.95,
area-range gt ignoring, crowd-IoF matching, 101-point interpolated PR. The
greedy matching runs in ``native/coco_match.cpp`` (built by
``utils/native.py``) or in the Python loop that is its tested reference;
``CocoEvaluator.matcher`` names the one in use and the log says it.

The output table (AP, AP50, AP75, APs/m/l, AR1/10/100) is the one
pycocotools prints after every eval.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import subprocess

import numpy as np

from ..utils import native
from . import rle_native
from .rle import rle_area, rle_iou

log = logging.getLogger(__name__)

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_matrix(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU (crowd -> IoF against dt area). dts (D,4) xyxy, gts (G,4)."""
    d_area = np.maximum(dts[:, 2] - dts[:, 0], 0) * np.maximum(dts[:, 3] - dts[:, 1], 0)
    g_area = np.maximum(gts[:, 2] - gts[:, 0], 0) * np.maximum(gts[:, 3] - gts[:, 1], 0)
    lt = np.maximum(dts[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dts[:, None, 2:], gts[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = d_area[:, None] + g_area[None, :] - inter
    union = np.where(iscrowd[None, :], d_area[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mask_iou_matrix(dt_masks, gt_masks, iscrowd) -> np.ndarray:
    """IoU between masks given as RLE dicts (preferred: run-merge via the
    native C++ codec, no decode) or raw (H, W) bool arrays."""
    d = len(dt_masks)
    g = len(gt_masks)
    if d == 0 or g == 0:
        # (the JAX function reaches the raw-array branch here and fails on
        # RLE dicts: an image with detections of a class it has no gt of)
        return np.zeros((d, g))
    if isinstance(dt_masks[0], dict) and isinstance(gt_masks[0], dict):
        if rle_native.available():
            return rle_native.iou_matrix(dt_masks, gt_masks, np.asarray(iscrowd))
        out = np.zeros((d, g))
        for i in range(d):
            for j in range(g):
                out[i, j] = rle_iou(dt_masks[i], gt_masks[j], bool(iscrowd[j]))
        return out
    out = np.zeros((d, g))
    d_area = np.array([m.sum() for m in dt_masks], np.float64)
    g_area = np.array([m.sum() for m in gt_masks], np.float64)
    for i in range(d):
        for j in range(g):
            inter = np.logical_and(dt_masks[i], gt_masks[j]).sum()
            union = d_area[i] if iscrowd[j] else d_area[i] + g_area[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


@functools.lru_cache(maxsize=None)
def native_matcher():
    """ctypes handle of ``native/coco_match.cpp``, or None (logged) where it
    cannot be built."""
    try:
        lib = native.load("coco_match")
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        log.warning("native COCO matcher unavailable, the Python matcher runs: %s", err)
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    up = ctypes.POINTER(ctypes.c_uint8)
    lp = ctypes.POINTER(ctypes.c_int64)
    lib.coco_match.restype = None
    lib.coco_match.argtypes = [dp, ctypes.c_int, ctypes.c_int, up, up,
                               dp, ctypes.c_int, lp, up, lp]
    log.info("native COCO matcher: %s", lib._name)
    return lib


def _match_image_category(dt_scores, ious, gt_ignore, gt_iscrowd, thrs, lib=None):
    """Greedy COCO matching for one (image, category).

    dt must already be score-sorted desc. Returns (dt_matched_gt (T, D) int
    [-1 = unmatched], dt_ignored (T, D) bool) for each IoU threshold.
    ``lib``: the C++ core (``native_matcher()``); None runs the Python loop
    below, its tested reference.
    """
    d = len(dt_scores)
    g = ious.shape[1] if d else 0
    t = len(thrs)
    dtm = np.full((t, d), -1, np.int64)
    dt_ig = np.zeros((t, d), bool)
    if d == 0:
        return dtm, dt_ig

    if lib is not None:
        ious_c = np.ascontiguousarray(ious, np.float64)
        gi = np.ascontiguousarray(gt_ignore, np.uint8)
        gc = np.ascontiguousarray(gt_iscrowd, np.uint8)
        th = np.ascontiguousarray(thrs, np.float64)
        out_ig = np.zeros((t, d), np.uint8)
        gtm = np.zeros((max(g, 1),), np.int64)
        lib.coco_match(
            ious_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), d, g,
            gi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            gc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            th.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), t,
            dtm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_ig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            gtm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return dtm, out_ig.astype(bool)

    for ti, thr in enumerate(thrs):
        gtm = np.full((g,), -1, np.int64)
        for di in range(d):
            best = -1
            best_iou = min(thr, 1 - 1e-10)
            for gi in range(g):
                # gt already matched (crowd can absorb many)
                if gtm[gi] >= 0 and not gt_iscrowd[gi]:
                    continue
                # once we have a non-ignored match, never switch to ignored gt
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best >= 0:
                dtm[ti, di] = best
                gtm[best] = di
                dt_ig[ti, di] = gt_ignore[best]
    return dtm, dt_ig


class CocoEvaluator:
    """Accumulates per-image detections; computes the COCO metric table.

    ``gt`` entries are dicts: image_id, category (contiguous label), bbox xyxy,
    area, iscrowd, and optionally ``mask`` ((H, W) bool) for segm eval.
    ``detections`` entries: image_id, boxes (D, 4), scores (D,), labels (D,),
    optionally masks (list of (H, W) bool). ``matcher`` names the greedy
    matching that runs: "native" (``native/coco_match.cpp``) where it
    builds, else "python".
    """

    def __init__(self, gts: list, num_classes: int, iou_type: str = "bbox"):
        self._lib = native_matcher()
        self.matcher = "native" if self._lib is not None else "python"
        self.num_classes = num_classes
        self.iou_type = iou_type
        self.gt_by_img_cat: dict = {}
        self.img_ids = set()
        for ann in gts:
            self.img_ids.add(ann["image_id"])
            key = (ann["image_id"], int(ann["category"]))
            self.gt_by_img_cat.setdefault(key, []).append(ann)
        self.dt_by_img_cat: dict = {}

    def add(self, image_id, boxes, scores, labels, masks=None):
        boxes = np.asarray(boxes, np.float64)
        scores = np.asarray(scores, np.float64)
        labels = np.asarray(labels, np.int64)
        for c in np.unique(labels):
            sel = labels == c
            entry = {
                "boxes": boxes[sel], "scores": scores[sel],
                "masks": [m for m, s in zip(masks, sel) if s] if masks is not None else None,
            }
            prev = self.dt_by_img_cat.get((image_id, int(c)))
            if prev is not None:  # repeated adds accumulate (e.g. TTA passes)
                if (prev["masks"] is None) != (entry["masks"] is None):
                    # silently dropping one side's masks would desync
                    # masks[i] from boxes[i] and corrupt segm matching
                    raise ValueError(
                        f"inconsistent masks= usage across add() calls for "
                        f"image {image_id} category {int(c)}")
                entry = {
                    "boxes": np.concatenate([prev["boxes"], entry["boxes"]]),
                    "scores": np.concatenate([prev["scores"], entry["scores"]]),
                    "masks": (prev["masks"] + entry["masks"])
                    if entry["masks"] is not None else None,
                }
            self.dt_by_img_cat[(image_id, int(c))] = entry

    def _area(self, ann):
        if "area" in ann and ann["area"] is not None:
            return ann["area"]
        b = ann["bbox"]
        return max(b[2] - b[0], 0) * max(b[3] - b[1], 0)

    def _dt_area(self, entry, i):
        if self.iou_type == "segm" and entry["masks"] is not None:
            m = entry["masks"][i]
            if isinstance(m, dict):
                return float(rle_area(m))
            return float(m.sum())
        b = entry["boxes"][i]
        return max(b[2] - b[0], 0) * max(b[3] - b[1], 0)

    def evaluate(self) -> dict:
        log.info("COCO %s eval: %s matcher, %s RLE codec", self.iou_type, self.matcher,
                 rle_native.implementation())
        t = len(IOU_THRS)
        results = {}
        # eval_imgs[(cat, area)] -> list of per-image match records
        per_cat_area: dict = {}

        for cat in range(self.num_classes):
            for img in self.img_ids:
                gts = self.gt_by_img_cat.get((img, cat), [])
                entry = self.dt_by_img_cat.get((img, cat))
                d = 0 if entry is None else len(entry["scores"])
                if not gts and d == 0:
                    continue
                # sort dts by score desc, cap at max dets (100)
                if d:
                    order = np.argsort(-entry["scores"], kind="mergesort")[: MAX_DETS[-1]]
                    scores = entry["scores"][order]
                    boxes = entry["boxes"][order]
                    masks = ([entry["masks"][i] for i in order]
                             if entry["masks"] is not None else None)
                else:
                    scores = np.zeros((0,))
                    boxes = np.zeros((0, 4))
                    masks = [] if self.iou_type == "segm" else None
                d = len(scores)

                gt_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
                gt_crowd = np.asarray([bool(g.get("iscrowd", 0)) for g in gts], bool)
                gt_areas = np.asarray([self._area(g) for g in gts], np.float64)

                if self.iou_type == "segm":
                    gt_masks = [g["mask"] for g in gts]
                    ious = mask_iou_matrix(masks, gt_masks, gt_crowd) if d else np.zeros((0, len(gts)))
                else:
                    ious = bbox_iou_matrix(boxes, gt_boxes, gt_crowd) if d else np.zeros((0, len(gts)))

                dt_areas = np.asarray([self._dt_area(
                    {"boxes": boxes, "masks": masks}, i) for i in range(d)])

                for aname, (lo, hi) in AREA_RANGES.items():
                    gt_ignore = gt_crowd | (gt_areas < lo) | (gt_areas > hi)
                    # order gts: non-ignored first (COCO convention)
                    gorder = np.argsort(gt_ignore, kind="mergesort")
                    ious_o = ious[:, gorder] if len(gts) else ious
                    dtm, dt_ig = _match_image_category(
                        scores, ious_o, gt_ignore[gorder],
                        gt_crowd[gorder], IOU_THRS, self._lib)
                    # unmatched dts outside the range are ignored too
                    out_of_range = (dt_areas < lo) | (dt_areas > hi)
                    dt_ig = dt_ig | ((dtm == -1) & out_of_range[None, :])
                    per_cat_area.setdefault((cat, aname), []).append({
                        "scores": scores,
                        "matched": dtm >= 0,
                        "dt_ignore": dt_ig,
                        "num_gt": int((~gt_ignore).sum()),
                    })

        # accumulate PR curves
        precision = np.full((t, len(RECALL_THRS), self.num_classes, len(AREA_RANGES),
                             len(MAX_DETS)), -1.0)
        recall = np.full((t, self.num_classes, len(AREA_RANGES), len(MAX_DETS)), -1.0)

        for (cat, aname), recs in per_cat_area.items():
            ai = list(AREA_RANGES).index(aname)
            for mi, max_det in enumerate(MAX_DETS):
                scores = np.concatenate([r["scores"][:max_det] for r in recs])
                matched = np.concatenate([r["matched"][:, :max_det] for r in recs], axis=1)
                ignored = np.concatenate([r["dt_ignore"][:, :max_det] for r in recs], axis=1)
                num_gt = sum(r["num_gt"] for r in recs)
                if num_gt == 0:
                    continue
                order = np.argsort(-scores, kind="mergesort")
                matched = matched[:, order]
                ignored = ignored[:, order]
                tps = np.cumsum(matched & ~ignored, axis=1).astype(np.float64)
                fps = np.cumsum(~matched & ~ignored, axis=1).astype(np.float64)
                for ti in range(t):
                    tp, fp = tps[ti], fps[ti]
                    nd = len(tp)
                    rc = tp / num_gt
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[ti, cat, ai, mi] = rc[-1] if nd else 0.0
                    # precision envelope (monotone non-increasing)
                    pr = pr.tolist()
                    for i in range(nd - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.zeros(len(RECALL_THRS))
                    for ri, pi in enumerate(inds):
                        if pi < nd:
                            q[ri] = pr[pi]
                    precision[ti, :, cat, ai, mi] = q

        def _summ(p_sel):
            valid = p_sel[p_sel > -1]
            return float(valid.mean()) if valid.size else -1.0

        a_all = list(AREA_RANGES).index("all")
        m100 = MAX_DETS.index(100)
        results["AP"] = _summ(precision[:, :, :, a_all, m100])
        results["AP50"] = _summ(precision[0, :, :, a_all, m100])
        results["AP75"] = _summ(precision[5, :, :, a_all, m100])
        for aname in ("small", "medium", "large"):
            ai = list(AREA_RANGES).index(aname)
            results[f"AP_{aname}"] = _summ(precision[:, :, :, ai, m100])
        for mi, md in enumerate(MAX_DETS):
            results[f"AR{md}"] = _summ(recall[:, :, a_all, mi])
        for aname in ("small", "medium", "large"):
            ai = list(AREA_RANGES).index(aname)
            results[f"AR_{aname}"] = _summ(recall[:, :, ai, m100])
        return results


def format_table(results: dict, iou_type: str = "bbox") -> str:
    """The canonical 12-line COCOeval console table (parity artifact)."""
    lines = []
    rows = [
        ("Average Precision", "AP", "0.50:0.95", "all", 100, results["AP"]),
        ("Average Precision", "AP", "0.50", "all", 100, results["AP50"]),
        ("Average Precision", "AP", "0.75", "all", 100, results["AP75"]),
        ("Average Precision", "AP", "0.50:0.95", "small", 100, results["AP_small"]),
        ("Average Precision", "AP", "0.50:0.95", "medium", 100, results["AP_medium"]),
        ("Average Precision", "AP", "0.50:0.95", "large", 100, results["AP_large"]),
        ("Average Recall", "AR", "0.50:0.95", "all", 1, results["AR1"]),
        ("Average Recall", "AR", "0.50:0.95", "all", 10, results["AR10"]),
        ("Average Recall", "AR", "0.50:0.95", "all", 100, results["AR100"]),
        ("Average Recall", "AR", "0.50:0.95", "small", 100, results["AR_small"]),
        ("Average Recall", "AR", "0.50:0.95", "medium", 100, results["AR_medium"]),
        ("Average Recall", "AR", "0.50:0.95", "large", 100, results["AR_large"]),
    ]
    for name, kind, iou, area, md, val in rows:
        lines.append(
            f" {name:<18} ({kind}) @[ IoU={iou:<9} | area={area:>6} | "
            f"maxDets={md:>3} ] = {val:0.3f}")
    return "\n".join(lines)
