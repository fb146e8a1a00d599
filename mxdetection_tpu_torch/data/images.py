"""Image files on the host: binary PPM (P6) read and written with numpy, and
every other format (JPEG, PNG) decoded by Pillow, imported only there.

The synthetic datasets (``make_synthetic_coco``, ``make_synthetic_voc``)
write PPM, so nothing that runs on them needs Pillow; a real dataset's JPEGs
do, and a missing Pillow raises an error that names the file.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def write_ppm(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB -> binary PPM."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"PPM holds RGB images, got {c} channels")
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(image.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, maxval 255, comments allowed in the header) -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"{path}: not a binary 8-bit PPM ({magic!r}, maxval {maxval})")
    pos += 1  # the single whitespace byte after maxval
    return np.frombuffer(data, np.uint8, h * w * 3, pos).reshape(h, w, 3).copy()


def read_image(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 RGB: PPM by ``read_ppm``,
    anything else by Pillow."""
    with open(path, "rb") as f:
        if f.read(2) == b"P6":
            return read_ppm(path)
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"decoding {path} needs Pillow, which is not installed "
                          "(the port reads binary PPM without it)") from err
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


_PRECISION_BITS = 22  # Pillow's fixed point for 8-bit resampling


def _bilinear_coeffs(in_size: int, out_sizes: list, device):
    """Pillow's bilinear ``precompute_coeffs`` + ``normalize_coeffs_8bpc``
    for D resizes of one axis from ``in_size`` to ``out_sizes`` (D ints), in
    float64 on ``device``: (D, max(out_sizes), K) input indices and 22-bit
    fixed-point weights, 0 past each output's support."""
    scale = in_size / torch.tensor(out_sizes, dtype=torch.float64, device=device)
    filterscale = scale.clamp(min=1.0)
    ksize = int(math.ceil(max(in_size / min(out_sizes), 1.0))) * 2 + 1
    center = (torch.arange(max(out_sizes), device=device, dtype=torch.float64) + 0.5
              ) * scale[:, None]
    xmin = (center - filterscale[:, None] + 0.5).long().clamp(min=0)
    xmax = (center + filterscale[:, None] + 0.5).long().clamp(max=in_size) - xmin
    j = torch.arange(ksize, device=device)
    x = ((j + xmin[..., None]) - center[..., None] + 0.5) * (1.0 / filterscale)[:, None, None]
    k = torch.where(j < xmax[..., None], (1.0 - x.abs()).clamp(min=0.0), 0.0)
    ww = k[..., 0]
    for jj in range(1, ksize):  # Pillow's order of summation
        ww = ww + k[..., jj]
    k = torch.where(ww[..., None] != 0, k / ww[..., None], k)
    one = float(1 << _PRECISION_BITS)
    kk = torch.where(k < 0, torch.trunc(-0.5 + k * one), torch.trunc(0.5 + k * one))
    return (xmin[..., None] + j).clamp(max=in_size - 1), kk.int()


def bilinear_pass(src: torch.Tensor, axis: int, out_sizes: list) -> torch.Tensor:
    """One pass of Pillow's BILINEAR resize over D uint8-valued int32 images
    ``src`` (D, H, W) along ``axis`` (1: rows, 2: columns), image d to
    ``out_sizes[d]``, padded to the largest; on ``src``'s device, in
    Pillow's 22-bit fixed point (antialiased when it shrinks), so a
    horizontal pass, then a vertical one, gives Pillow's values exactly."""
    idx, kk = _bilinear_coeffs(src.shape[axis], out_sizes, src.device)
    shape = list(src.shape)
    shape[axis] = max(out_sizes)
    acc = torch.full(shape, 1 << (_PRECISION_BITS - 1), dtype=torch.int32, device=src.device)
    for jj in range(idx.shape[-1]):
        i, w = (idx[:, :, None, jj], kk[:, :, None, jj]) if axis == 1 else (
            idx[:, None, :, jj], kk[:, None, :, jj])
        acc += torch.gather(src, axis, i.expand(shape)) * w
    return (acc >> _PRECISION_BITS).clamp(0, 255)


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) as Pillow's ``Image.resize((out_w,
    out_h), BILINEAR)`` computes it (``bilinear_pass`` on each channel)."""
    t = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))).int()
    c = t.shape[0]
    t = bilinear_pass(bilinear_pass(t, 2, [out_w] * c), 1, [out_h] * c)
    return t.permute(1, 2, 0).to(torch.uint8).numpy()


def write_image(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB: ``.ppm`` by ``write_ppm``, any other
    extension by Pillow."""
    if path.lower().endswith(".ppm"):
        write_ppm(path, image)
        return
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"writing {path} needs Pillow, which is not installed "
                          "(write a .ppm instead)") from err
    Image.fromarray(np.ascontiguousarray(image, np.uint8)).save(path)
