"""COCO dataset: annotation JSON -> ImageRecords — port of
``mxdetection_tpu.data.coco`` (no pycocotools, no Pillow).

Per-image record: image_id, file, (h, w), boxes (G, 4) float32 xyxy, labels
(G,) int32 contiguous [0, C), is_crowd (G,) bool, areas, polygons (host
only) and box_masks (G, M, M) uint8, each instance's mask rasterized into
its own box at MxM (the training targets are affine crops of these).

The polygon rasterizer is numpy (``fill_polygon``): the scanline fill of
Pillow's ``ImageDraw.polygon``, which the JAX package calls, without
Pillow. It equals Pillow's on convex polygons (rectangles, the synthetic
sets' ellipses); at the concave corners of other polygons Pillow moves a
few edge pixels that this fill does not (``tests/test_torch_port_data_eval.py``
bounds the difference). Synthetic images are written as binary PPM
(``images.py``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from .images import read_image, write_ppm


@dataclass
class ImageRecord:
    image_id: int
    file: str
    height: int
    width: int
    boxes: np.ndarray          # (G, 4) xyxy float32
    labels: np.ndarray         # (G,) int32, contiguous [0, num_classes)
    is_crowd: np.ndarray       # (G,) bool
    areas: np.ndarray | None = None                # (G,) float annotation areas
    polygons: list = field(default_factory=list)   # per instance: list of (P, 2) arrays
    box_masks: np.ndarray | None = None            # (G, M, M) uint8, lazy


def _round_up(x: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_UP``: halves away from zero."""
    return np.where(x >= 0, np.floor(x + np.float32(0.5)),
                    -np.floor(np.abs(x) + np.float32(0.5))).astype(np.int64)


def _round_down(x: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_DOWN``: halves toward zero."""
    return np.where(x >= 0, np.ceil(x - np.float32(0.5)),
                    -np.ceil(np.abs(x) - np.float32(0.5))).astype(np.int64)


def fill_polygon(out: np.ndarray, points, value=1) -> None:
    """Fill a polygon into the (H, W[, C]) array ``out`` in place, by the
    scanline rule of Pillow's ``ImageDraw.polygon(fill=...)``.

    Vertices are truncated to integers; each edge is (x0, y0) + dx per row in
    float32; every row from the top vertex to the bottom one (clipped to the
    image) pairs up its sorted edge crossings, an edge's bottom row counting
    twice except on the last row, and fills each pair from the rounded-up
    left crossing to the rounded-down right one; horizontal edges (runs of
    them merged) fill their own row.
    """
    h, w = out.shape[:2]
    xy = np.trunc(np.asarray(points, np.float64).reshape(-1, 2)).astype(np.int64)
    n = len(xy)
    edges = []  # [xmin, xmax, ymin, ymax, x0, y0, x1, y1]
    for i in range(n - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1, 1]:
            if x1 > x0 > xy[i - 1, 0]:   # a horizontal run going right
                edges[-1][1] = x1
                continue
            if x1 < x0 < xy[i - 1, 0]:   # going left
                edges[-1][0] = x1
                continue
        edges.append([min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), x0, y0, x1, y1])
    if n and (xy[-1] != xy[0]).any():
        (x0, y0), (x1, y1) = xy[-1], xy[0]
        edges.append([min(x0, x1), max(x0, x1), min(y0, y1), max(y0, y1), x0, y0, x1, y1])
    if not edges:
        return
    e = np.asarray(edges, np.int64)
    ymin, ymax = min(h - 1, int(e[:, 2].min())), max(0, int(e[:, 3].max()))
    spans = [(e[k, 2], e[k, 0], e[k, 1]) for k in np.flatnonzero(e[:, 2] == e[:, 3])]
    e = e[e[:, 2] != e[:, 3]]
    ymin, ymax = max(ymin, 0), min(ymax, h)
    if len(e):
        ys = np.arange(ymin, ymax + 1)[:, None]
        dx = (e[:, 6] - e[:, 4]).astype(np.float32) / (e[:, 7] - e[:, 5]).astype(np.float32)
        x = (ys - e[:, 5]).astype(np.float32) * dx + e[:, 4].astype(np.float32)
        active = (ys >= e[:, 2]) & (ys <= e[:, 3])
        twice = active & (ys == e[:, 3]) & (ys < ymax)
        inf = np.float32(np.inf)
        xx = np.sort(np.concatenate([np.where(active, x, inf), np.where(twice, x, inf)], 1), 1)
        count = active.sum(1) + twice.sum(1)
        left, right = xx[:, 0::2], xx[:, 1::2]
        pair = 2 * np.arange(right.shape[1]) + 1 < count[:, None]
        x_end = _round_down(np.where(pair, right, 0))
        pair &= x_end >= np.where(pair, left, 0)
        x_start = _round_up(np.where(pair, left, 0))
        rows = np.broadcast_to(ys, pair.shape)[pair]
        spans += list(zip(rows, x_start[pair], x_end[pair]))
    for y, x0, x1 in spans:  # Pillow's hline: clipped to the image, inclusive
        if 0 <= y < h and x0 < w and x1 >= 0:
            out[y, max(x0, 0):min(x1, w - 1) + 1] = value


def rasterize_polygons_in_box(polygons, box, out_size: int) -> np.ndarray:
    """Rasterize an instance's polygons into its own bounding box at MxM
    (the training targets are affine crops of these, ``ops/mask_target.py``)."""
    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    img = np.zeros((out_size, out_size), np.uint8)
    for poly in polygons:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        p[:, 0] = (p[:, 0] - x1) / w * out_size
        p[:, 1] = (p[:, 1] - y1) / h * out_size
        if len(p) >= 3:
            fill_polygon(img, p)
    return img


def rasterize_full_mask(polygons, height: int, width: int) -> np.ndarray:
    """Rasterize an instance's polygons at full image resolution (eval-side)."""
    img = np.zeros((height, width), bool)
    for poly in polygons:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(p) >= 3:
            fill_polygon(img, p)
    return img


class CocoDataset:
    """Parses a COCO-format annotation file; serves ImageRecords.

    ``category_ids`` maps contiguous label -> original COCO category id
    (needed when emitting detection JSON for eval).
    """

    def __init__(self, ann_file: str, image_dir: str, *,
                 with_masks: bool = False, box_mask_size: int = 28,
                 filter_empty: bool = True, min_box_size: float = 1e-3):
        with open(ann_file) as f:
            ann = json.load(f)

        self.image_dir = image_dir
        self.with_masks = with_masks
        self.box_mask_size = box_mask_size

        cats = sorted(ann["categories"], key=lambda c: c["id"])
        self.category_ids = [c["id"] for c in cats]
        self.category_names = [c["name"] for c in cats]
        self.num_classes = len(cats)
        cat_to_label = {c["id"]: i for i, c in enumerate(cats)}

        per_image: dict[int, list] = {}
        for a in ann.get("annotations", []):
            per_image.setdefault(a["image_id"], []).append(a)

        self.records: list[ImageRecord] = []
        for im in ann["images"]:
            anns = per_image.get(im["id"], [])
            boxes, labels, crowd, polys, areas = [], [], [], [], []
            for a in anns:
                x, y, w, h = a["bbox"]
                if w < min_box_size or h < min_box_size:
                    continue
                boxes.append([x, y, x + w, y + h])
                labels.append(cat_to_label[a["category_id"]])
                crowd.append(bool(a.get("iscrowd", 0)))
                areas.append(float(a.get("area", w * h)))
                seg = a.get("segmentation")
                polys.append(seg if isinstance(seg, list) else [])
            if filter_empty and not boxes:
                continue
            self.records.append(ImageRecord(
                image_id=im["id"],
                file=os.path.join(image_dir, im["file_name"]),
                height=im["height"],
                width=im["width"],
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                is_crowd=np.asarray(crowd, bool),
                areas=np.asarray(areas, np.float64),
                polygons=polys,
            ))

    def __len__(self) -> int:
        return len(self.records)

    def load_image(self, rec: ImageRecord) -> np.ndarray:
        """Decode to uint8 (H, W, 3) RGB on the host; everything after runs on the device."""
        return read_image(rec.file)

    def get_box_masks(self, rec: ImageRecord) -> np.ndarray:
        if rec.box_masks is None:
            m = self.box_mask_size
            out = np.zeros((len(rec.boxes), m, m), np.uint8)
            for i, polys in enumerate(rec.polygons):
                if polys:
                    out[i] = rasterize_polygons_in_box(polys, rec.boxes[i], m)
            rec.box_masks = out
        return rec.box_masks


def make_synthetic_coco(root: str, num_images: int = 16, size_range=(240, 400),
                        num_classes: int = 5, max_objects: int = 6, seed: int = 0,
                        split: str = "train", min_objects: int = 1) -> tuple[str, str]:
    """Generate a tiny valid COCO dataset (PPM images + JSON) for tests and
    smoke training. Objects are bright rectangles and ellipses (16-gons) on
    dark noise, so a detector can overfit them. The draws are those of the
    JAX package's ``make_synthetic_coco``: with ``min_objects=1`` the same
    seed gives the same annotations."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, f"images_{split}")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(num_images):
        h = int(rng.randint(*size_range))
        w = int(rng.randint(*size_range))
        img = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        n_obj = rng.randint(min_objects, max_objects + 1)
        for _ in range(n_obj):
            bw = rng.randint(int(0.15 * w), int(0.45 * w))
            bh = rng.randint(int(0.15 * h), int(0.45 * h))
            x = rng.randint(0, w - bw)
            y = rng.randint(0, h - bh)
            cls = int(rng.randint(num_classes))
            color = np.clip((60 + 39 * cls, 255 - 39 * cls, 128 + 25 * cls), 0, 255)
            if cls % 2 == 0:
                img[y:y + bh + 1, x:x + bw + 1] = color
                seg = [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]
            else:
                t = np.linspace(0, 2 * np.pi, 17)[:-1]
                px = x + bw / 2 + bw / 2 * np.cos(t)
                py = y + bh / 2 + bh / 2 * np.sin(t)
                seg = [np.stack([px, py], 1).reshape(-1).tolist()]
                fill_polygon(img, np.asarray(seg[0]), color)
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": cls + 1,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0, "segmentation": seg,
            })
            ann_id += 1
        fname = f"{i:06d}.ppm"
        write_ppm(os.path.join(img_dir, fname), img)
        images.append({"id": i, "file_name": fname, "height": h, "width": w})

    ann = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c + 1, "name": f"class{c}"} for c in range(num_classes)],
    }
    ann_file = os.path.join(root, f"instances_{split}.json")
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return ann_file, img_dir
