"""PASCAL VOC dataset: XML annotation parsing -> ImageRecords + VOC mAP eval
— port of ``mxdetection_tpu.data.voc`` (the same records and protocol).

Produces the same ImageRecord structure as the COCO loader, so the loader,
trainer and evaluator are shared; only annotation parsing and the mAP
protocol differ. An image is ``JPEGImages/<id>`` with the first of the
extensions ``IMAGE_EXTS`` that exists (the synthetic set writes PPM).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .coco import ImageRecord
from .images import read_image, write_ppm

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".ppm")


def _image_file(image_dir: str, image_id: str) -> str:
    """``image_dir/<image_id><ext>`` for the first extension that exists
    (".jpg" when none does, so that the read names the missing file)."""
    for ext in IMAGE_EXTS:
        path = os.path.join(image_dir, image_id + ext)
        if os.path.exists(path):
            return path
    return os.path.join(image_dir, image_id + IMAGE_EXTS[0])


class VocDataset:
    """VOCdevkit layout: root/{JPEGImages,Annotations,ImageSets/Main}.

    API-compatible subset of CocoDataset (records, num_classes, load_image).
    """

    def __init__(self, root: str, split: str = "trainval", year: str = "2007",
                 use_difficult: bool = False):
        base = os.path.join(root, f"VOC{year}")
        split_file = os.path.join(base, "ImageSets", "Main", split + ".txt")
        with open(split_file) as f:
            ids = [line.strip() for line in f if line.strip()]

        self.num_classes = len(VOC_CLASSES)
        self.category_names = list(VOC_CLASSES)
        self.category_ids = list(range(1, self.num_classes + 1))
        cls_to_label = {c: i for i, c in enumerate(VOC_CLASSES)}

        self.records: list[ImageRecord] = []
        for k, image_id in enumerate(ids):
            ann_path = os.path.join(base, "Annotations", image_id + ".xml")
            tree = ET.parse(ann_path)
            size = tree.find("size")
            w = int(size.find("width").text)
            h = int(size.find("height").text)
            boxes, labels, difficult = [], [], []
            for obj in tree.findall("object"):
                name = obj.find("name").text.strip().lower()
                if name not in cls_to_label:
                    continue
                diff = int(obj.find("difficult").text or 0) if obj.find("difficult") is not None else 0
                if diff and not use_difficult:
                    diff = 1
                bb = obj.find("bndbox")
                # VOC boxes are 1-indexed inclusive
                x1 = float(bb.find("xmin").text) - 1
                y1 = float(bb.find("ymin").text) - 1
                x2 = float(bb.find("xmax").text) - 1
                y2 = float(bb.find("ymax").text) - 1
                boxes.append([x1, y1, x2, y2])
                labels.append(cls_to_label[name])
                difficult.append(bool(diff))
            if not boxes:
                continue
            self.records.append(ImageRecord(
                image_id=k,
                file=_image_file(os.path.join(base, "JPEGImages"), image_id),
                height=h, width=w,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                # "difficult" plays the crowd/ignore role in matching
                is_crowd=np.asarray(difficult, bool),
                areas=None, polygons=[[] for _ in boxes],
            ))

    def __len__(self):
        return len(self.records)

    def load_image(self, rec: ImageRecord) -> np.ndarray:
        return read_image(rec.file)


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC AP: 11-point interpolation (2007) or area under the PR envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.flatnonzero(mrec[1:] != mrec[:-1])
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_voc(detections: list, dataset: VocDataset, iou_thr: float = 0.5,
                 use_07_metric: bool = False) -> dict:
    """VOC mAP. ``detections``: per-image dicts (image_id, boxes, scores, labels).

    Difficult gts are excluded from the gt count and ignore matched dts,
    per the official protocol.
    """
    gt_by_img = {r.image_id: r for r in dataset.records}
    aps = {}
    for c in range(dataset.num_classes):
        # collect class dts across images
        img_ids, boxes, scores = [], [], []
        for det in detections:
            sel = np.asarray(det["labels"]) == c
            for b, s in zip(np.asarray(det["boxes"])[sel], np.asarray(det["scores"])[sel]):
                img_ids.append(det["image_id"])
                boxes.append(b)
                scores.append(s)
        npos = 0
        gt_state = {}
        for r in dataset.records:
            sel = r.labels == c
            g = r.boxes[sel]
            diff = r.is_crowd[sel]
            npos += int((~diff).sum())
            gt_state[r.image_id] = {"boxes": g, "difficult": diff,
                                    "matched": np.zeros(len(g), bool)}
        if npos == 0:
            continue
        if not boxes:
            aps[c] = 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.zeros(len(order))
        fp = np.zeros(len(order))
        for rank, di in enumerate(order):
            st = gt_state.get(img_ids[di])
            if st is None or len(st["boxes"]) == 0:
                fp[rank] = 1
                continue
            bb = boxes[di]
            g = st["boxes"]
            iw = np.minimum(g[:, 2], bb[2]) - np.maximum(g[:, 0], bb[0])
            ih = np.minimum(g[:, 3], bb[3]) - np.maximum(g[:, 1], bb[1])
            inter = np.maximum(iw, 0) * np.maximum(ih, 0)
            union = ((bb[2] - bb[0]) * (bb[3] - bb[1])
                     + (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1]) - inter)
            iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0)
            j = int(np.argmax(iou))
            if iou[j] >= iou_thr:
                if st["difficult"][j]:
                    continue  # ignore
                if not st["matched"][j]:
                    st["matched"][j] = True
                    tp[rank] = 1
                else:
                    fp[rank] = 1
            else:
                fp[rank] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        rec = ctp / npos
        prec = ctp / np.maximum(ctp + cfp, np.spacing(1))
        aps[c] = voc_ap(rec, prec, use_07_metric)
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"mAP": mean_ap, "per_class": {dataset.category_names[c]: v
                                          for c, v in aps.items()}}


def make_synthetic_voc(root: str, num_images: int = 16, size_range=(240, 400),
                       num_classes: int = 3, max_objects: int = 4,
                       seed: int = 0, split: str = "trainval",
                       year: str = "2007") -> str:
    """Generate a tiny valid VOCdevkit tree (PPMs + XMLs + ImageSets) for
    tests and smoke training, with the draws of the JAX package's
    ``make_synthetic_voc`` (the same seed gives the same annotations).
    Objects are bright rectangles on dark noise so a detector can overfit."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, f"VOC{year}")
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = []
    for i in range(num_images):
        iid = f"{i:06d}"
        ids.append(iid)
        h = int(rng.randint(*size_range))
        w = int(rng.randint(*size_range))
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        objs = ""
        for _ in range(int(rng.randint(1, max_objects + 1))):
            bw = rng.randint(int(0.2 * w), int(0.45 * w))
            bh = rng.randint(int(0.2 * h), int(0.45 * h))
            x = int(rng.randint(0, w - bw))
            y = int(rng.randint(0, h - bh))
            cls = int(rng.randint(num_classes))
            img[y:y + bh + 1, x:x + bw + 1] = np.clip(
                (60 + 39 * cls, 255 - 39 * cls, 128 + 25 * cls), 0, 255)
            objs += (f"\n  <object><name>{VOC_CLASSES[cls]}</name>"
                     f"<difficult>0</difficult>"
                     f"<bndbox><xmin>{x + 1}</xmin><ymin>{y + 1}</ymin>"
                     f"<xmax>{x + bw + 1}</xmax><ymax>{y + bh + 1}</ymax>"
                     f"</bndbox></object>")
        write_ppm(os.path.join(base, "JPEGImages", iid + ".ppm"), img)
        xml = (f"<annotation><size><width>{w}</width><height>{h}</height>"
               f"</size>{objs}\n</annotation>")
        with open(os.path.join(base, "Annotations", iid + ".xml"), "w") as f:
            f.write(xml)
    with open(os.path.join(base, "ImageSets", "Main", split + ".txt"),
              "w") as f:
        f.write("\n".join(ids))
    return root
