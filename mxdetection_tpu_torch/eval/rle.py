"""COCO RLE mask codec in numpy — port of ``mxdetection_tpu.eval.rle``
(the same code: it is framework-free, but the JAX package's ``eval``
package imports jax, so the port keeps its own copy).

The format is the public one of pycocotools' ``_mask``: column-major
uncompressed counts starting with the count of zeros, and the ASCII
LEB128-style compressed string. ``rle_native.py`` binds the C++ codec of
``native/rle.cpp`` with the same results.
"""

from __future__ import annotations

import numpy as np


def encode_rle(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> uncompressed RLE dict (column-major counts,
    starting with the count of zeros)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).reshape(-1, order="F").astype(np.int8)
    # run-length: positions where value changes
    diffs = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def decode_rle(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _uncompress_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def rle_area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _uncompress_counts(counts)
    return int(sum(counts[1::2]))


def compress_counts(counts: list) -> str:
    """COCO's LEB128-variant ascii compression (delta-coded from the 3rd run)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _uncompress_counts(s: str) -> list:
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_iou(dt: dict, gt: dict, iscrowd: bool = False) -> float:
    """IoU between two RLE masks (decode-free would be faster; this is the
    simple correct version — the C++ native path does run-merge)."""
    a = decode_rle(dt).astype(bool)
    b = decode_rle(gt).astype(bool)
    inter = np.logical_and(a, b).sum()
    if iscrowd:
        da = a.sum()
        return inter / da if da else 0.0
    union = np.logical_or(a, b).sum()
    return inter / union if union else 0.0
