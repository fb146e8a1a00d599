"""Wrappers of the CUDA RoIAlign kernels (``csrc/roi_align.cu``,
``csrc/roi_align_bwd.cu``).

Counterparts of ``mxdetection_tpu/ops/pallas/roi_align.py``: ``_kernel``
(K1, the forward), ``_bwd_kernel`` (K3, the backward) and ``kern`` in
``_convert_pallas`` (K3b, the f32 -> bf16 convert of K3's sums, here the
epilogue of K3's kernel). Reached from
``ops/roi_align.py::multilevel_roi_align`` for CUDA tensors, through the
operator ``mxdet::roi_align`` and its registered backward
(``ops/library.py``); the plain versions are
``multilevel_roi_align_plain`` and torch autograd of it.
``roi_align_bwd_tiles`` is the plain model of K3's partition into output
tiles and of its order of sums.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
from typing import Sequence

import torch

from ..roi_align import roi_sample_taps
from . import build
from .build import LaunchCount, check, load_library

launch_count = LaunchCount("roi_align")
bwd_launch_count = LaunchCount("roi_align_bwd")
# K3b is K3's epilogue: the launches of K3 that round their sums to bf16.
bwd_bf16_launch_count = LaunchCount("roi_align_bwd_bf16")

_DTYPES = (torch.float32, torch.bfloat16)


def _level_arrays(shapes: Sequence[tuple[int, int]], strides: Sequence[int]):
    n = len(shapes)
    return (n, (ctypes.c_int * n)(*[h for h, _ in shapes]),
            (ctypes.c_int * n)(*[w for _, w in shapes]),
            (ctypes.c_float * n)(*[1.0 / float(s) for s in strides]))


def _check_rois(what, b, r, rois, levels, roi_valid, dev):
    if rois.shape != (b, r, 4) or levels.shape != (b, r) or roi_valid.shape != (b, r):
        raise ValueError(f"{what}: rois {tuple(rois.shape)}, levels "
                         f"{tuple(levels.shape)}, roi_valid {tuple(roi_valid.shape)}")
    if rois.device != dev or levels.device != dev or roi_valid.device != dev:
        raise ValueError(f"{what}: rois, levels and roi_valid must be on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}, expected a CUDA device")
    return (rois.float().contiguous(), levels.to(torch.int32).contiguous(),
            roi_valid.to(torch.bool).contiguous())


def roi_align_cuda(features: Sequence[torch.Tensor], rois: torch.Tensor,
                   strides: Sequence[int], levels: torch.Tensor, *,
                   output_size: int = 7, sampling_ratio: int = 2,
                   roi_valid: torch.Tensor | None = None) -> torch.Tensor:
    """features: per level (B, H_l, W_l, C) contiguous, f32 or bf16; rois
    (B, R, 4) f32; levels (B, R) int32 -> (B, R, P, P, C) in the feature dtype.
    A warp owns a bin row and a lane 16 bytes of channels; rows that are not
    whole 16-byte vectors (or a level not 16-byte aligned) take the same
    kernel with channel-by-channel loads."""
    b, r = rois.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    dev = rois.device
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align_cuda: feature dtype {dtype} not in {_DTYPES}")
    if not 1 <= c <= 1024:
        raise ValueError(f"roi_align_cuda: C={c} outside [1, 1024]")
    if not 1 <= len(features) <= 5 or len(strides) != len(features):
        raise ValueError("roi_align_cuda: 1 to 5 levels, one stride each")
    if output_size * sampling_ratio > 64:
        raise ValueError("roi_align_cuda: output_size * sampling_ratio must be <= 64")
    for f in features:
        if (f.device != dev or f.dtype != dtype or f.dim() != 4 or f.shape[0] != b
                or f.shape[-1] != c or not f.is_contiguous()):
            raise ValueError("roi_align_cuda: every level must be a contiguous "
                             f"(B, H, W, C) {dtype} tensor on {dev}")
    if roi_valid is None:
        roi_valid = torch.ones((b, r), dtype=torch.bool, device=dev)
    rois, levels, roi_valid = _check_rois("roi_align_cuda", b, r, rois, levels, roi_valid, dev)

    out = torch.empty((b, r, output_size, output_size, c), dtype=dtype, device=dev)
    n, hs, ws, scales = _level_arrays([tuple(f.shape[1:3]) for f in features], strides)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in features])
    # a lane loads 16 bytes of channels at once where the rows allow it
    vec = c * features[0].element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (*features, out))
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_roi_align_fwd(
            ptrs, hs, ws, scales, n, rois.data_ptr(), levels.data_ptr(),
            roi_valid.data_ptr(), out.data_ptr(), b * r, r, c, output_size,
            sampling_ratio, int(dtype == torch.bfloat16), int(vec), stream)
    check(err, "mxdet_roi_align_fwd")
    launch_count.add()
    return out


def roi_align_bwd_cuda(grad_out: torch.Tensor, feature_shapes: Sequence[tuple[int, int]],
                       rois: torch.Tensor, strides: Sequence[int], levels: torch.Tensor, *,
                       sampling_ratio: int = 2, roi_valid: torch.Tensor | None = None,
                       out_dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """K3 (with K3b as its epilogue): grad_out (B, R, P, P, C) f32 or bf16,
    the (H_l, W_l) of each level, rois (B, R, 4), levels (B, R) -> the
    gradient of each level's features, (B, H_l, W_l, C) in ``out_dtype``.
    A block owns an output tile and sums the terms of the rois that touch it
    in f32 registers, in a fixed order (``roi_align_bwd_tiles``), and writes
    the tile once, rounded to bf16 when ``out_dtype`` is bf16; nothing is
    zeroed or converted apart."""
    if grad_out.dim() != 5 or grad_out.shape[2] != grad_out.shape[3]:
        raise ValueError(f"roi_align_bwd_cuda: grad_out {tuple(grad_out.shape)}, "
                         "expected (B, R, P, P, C)")
    b, r, p, _, c = grad_out.shape
    dev = grad_out.device
    if grad_out.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"roi_align_bwd_cuda: dtypes {grad_out.dtype} -> {out_dtype} "
                        f"not in {_DTYPES}")
    if not 1 <= c <= 1024:
        raise ValueError(f"roi_align_bwd_cuda: C={c} outside [1, 1024]")
    if not 1 <= len(feature_shapes) <= 5 or len(strides) != len(feature_shapes):
        raise ValueError("roi_align_bwd_cuda: 1 to 5 levels, one stride each")
    if p * sampling_ratio > 64:
        raise ValueError("roi_align_bwd_cuda: output_size * sampling_ratio must be <= 64")
    if not all(1 <= n <= 32767 for hw in feature_shapes for n in hw):
        raise ValueError(f"roi_align_bwd_cuda: level shapes {list(feature_shapes)} outside "
                         "[1, 32767]")
    if roi_valid is None:
        roi_valid = torch.ones((b, r), dtype=torch.bool, device=dev)
    rois, levels, roi_valid = _check_rois("roi_align_bwd_cuda", b, r, rois, levels,
                                          roi_valid, dev)
    grad_out = grad_out.contiguous()

    sizes = [b * h * w * c for h, w in feature_shapes]
    out = torch.empty(sum(sizes), dtype=out_dtype, device=dev)
    # the rois' footprints, then their axis tables: (B*R) * (1 + 2 P S) int4
    scratch = torch.empty((b * r * (1 + 2 * p * sampling_ratio), 4), dtype=torch.int32,
                          device=dev)
    n, hs, ws, scales = _level_arrays(feature_shapes, strides)
    ptrs = (ctypes.c_void_p * n)(*[v.data_ptr() for v in out.split(sizes)])
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxdet_roi_align_bwd(
            ptrs, hs, ws, scales, n, rois.data_ptr(), levels.data_ptr(),
            roi_valid.data_ptr(), grad_out.data_ptr(), scratch.data_ptr(), b, r, c, p,
            sampling_ratio, int(grad_out.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    check(err, "mxdet_roi_align_bwd")
    bwd_launch_count.add()
    if out_dtype == torch.bfloat16:
        bwd_bf16_launch_count.add()
    return [v.view(b, h, w, c) for v, (h, w) in zip(out.split(sizes), feature_shapes)]


# ------------------------------------------------------------ K3's partition
# The kernel's tile and chunk live in its source alone; the plain model
# reads them from there (``roi_align_bwd_config``). On the card they are held
# against what the built kernel reports (``roi_align_bwd_layout_cuda``).
BWD_SOURCE = "roi_align_bwd.cu"


@functools.lru_cache(maxsize=None)
def _bwd_constants(csrc_dir: str) -> dict:
    with open(os.path.join(csrc_dir, BWD_SOURCE)) as f:
        text = f.read()
    tile = re.search(r"constexpr int kTH = (\d+), kTW = (\d+);", text)
    lane = re.search(r"constexpr int kCV = (\d+);", text)
    if tile is None or lane is None:
        raise RuntimeError(f"{BWD_SOURCE}: kTH, kTW or kCV not found")
    th, tw = int(tile.group(1)), int(tile.group(2))
    return {"tile": (th, tw), "chunk": 32 * int(lane.group(1)), "threads": 32 * th}


def roi_align_bwd_config(csrc_dir: str | None = None) -> dict:
    """K3's partition from the kernel source's constants (``csrc_dir``, the
    package's by default): ``tile`` (rows, columns of cells a block owns),
    ``chunk`` (channels it sums) and ``threads`` (a warp per tile row)."""
    return dict(_bwd_constants(csrc_dir or build.CSRC_DIR))


def roi_align_bwd_stage_bytes(csrc_dir: str | None = None) -> int:
    """K3's shared-memory stage (``kStageBytes``), read from its source."""
    with open(os.path.join(csrc_dir or build.CSRC_DIR, BWD_SOURCE)) as f:
        m = re.search(r"constexpr int kStageBytes = (\d+)(?: \* (\d+))?;", f.read())
    if m is None:
        raise RuntimeError(f"{BWD_SOURCE}: kStageBytes not found")
    return int(m.group(1)) * int(m.group(2) or 1)


def roi_align_bwd_layout_cuda() -> dict:
    """What the built kernel reports, in ``roi_align_bwd_config``'s keys.
    Builds the library on first use; launches nothing."""
    out = (ctypes.c_int * 4)()
    check(load_library().mxdet_roi_align_bwd_layout(out), "mxdet_roi_align_bwd_layout")
    th, tw, chunk, threads = out
    return {"tile": (th, tw), "chunk": chunk, "threads": threads}


def roi_footprints(taps: tuple, roi_valid: torch.Tensor) -> torch.Tensor:
    """The cells each roi's samples touch with a nonzero weight, as
    (y0, y1, x0, x1) inclusive ranges on its level, (B, R, 4) int64 from
    ``roi_sample_taps``' output; an invalid roi, or one without a sample
    inside the map on either axis, gets the empty (2**30, -1, 2**30, -1)."""
    empty = 1 << 30
    rng = []
    for lo, hi, w_lo, w_hi in (taps[:4], taps[4:]):
        first = torch.where(w_lo != 0, lo, empty).amin(-1)
        last = torch.maximum(torch.where(w_lo != 0, lo, -1), torch.where(w_hi != 0, hi, -1))
        rng += [first, last.amax(-1)]
    fp = torch.stack(rng, -1)
    keep = roi_valid & (fp[..., 0] <= fp[..., 1]) & (fp[..., 2] <= fp[..., 3])
    return torch.where(keep[..., None], fp, fp.new_tensor([empty, -1, empty, -1]))


def roi_tile_pairs(footprints: torch.Tensor, levels: torch.Tensor,
                   feature_shapes: Sequence[tuple[int, int]],
                   tile: tuple[int, int] | None = None) -> tuple[int, int]:
    """(number of (roi, tile) pairs, longest roi list of a tile) of K3's
    partition: a roi is in the list of every tile of its level and image that
    its footprint meets. ``tile`` defaults to the kernel's."""
    th, tw = tile or roi_align_bwd_config()["tile"]
    b = footprints.shape[0]
    nonempty = footprints[..., 0] <= footprints[..., 1]
    pairs, longest = 0, 0
    for lvl, (h, w) in enumerate(feature_shapes):
        on = nonempty & (levels == lvl)
        fp = footprints[on]
        img = torch.arange(b, device=fp.device)[:, None].expand(on.shape)[on]
        ty0, ty1 = fp[:, 0] // th, fp[:, 1] // th + 1
        tx0, tx1 = fp[:, 2] // tw, fp[:, 3] // tw + 1
        pairs += int(((ty1 - ty0) * (tx1 - tx0)).sum())
        # each roi's rectangle of tiles added into a grid by its four corners
        ny, nx = -(-h // th) + 1, -(-w // tw) + 1
        grid = torch.zeros((b, ny, nx), dtype=torch.int64, device=fp.device)
        for ys, xs, sign in ((ty0, tx0, 1), (ty0, tx1, -1), (ty1, tx0, -1), (ty1, tx1, 1)):
            grid.index_put_((img, ys, xs), torch.full_like(ys, sign), accumulate=True)
        longest = max(longest, int(grid.cumsum(1).cumsum(2).max()))
    return pairs, longest


def _axis_bins(lo, hi, w_lo, w_hi, extent: int, tiles: int, s: int) -> torch.Tensor:
    """Along one axis, the bins in reach of each tile of ``extent`` cells:
    from the bin of the first sample whose lo or hi tap lands in the tile
    with a nonzero weight to the bin of the last; (..., n) -> (..., tiles),
    0 where no tap lands."""
    n = lo.shape[-1]
    t = torch.arange(tiles, device=lo.device)[:, None]
    on = ((((lo // extent)[..., None, :] == t) & (w_lo != 0)[..., None, :])
          | (((hi // extent)[..., None, :] == t) & (w_hi != 0)[..., None, :]))
    k = torch.arange(n, device=lo.device)
    first = torch.where(on, k, n).amin(-1)
    last = torch.where(on, k, -1).amax(-1)
    return torch.where(last >= 0, last // s - first // s + 1, 0)


def roi_stage_pairs(taps: tuple, footprints: torch.Tensor, levels: torch.Tensor,
                    feature_shapes: Sequence[tuple[int, int]], *, channels: int,
                    itemsize: int, sampling_ratio: int = 2) -> tuple:
    """Which (roi, tile) pairs of K3 read g from global memory: the block
    stages, for each roi of its list, the bins of g in reach of its tile
    (their channels of one chunk, zero-padded to a lane's), and a roi whose
    bins alone take more than the stage (``kStageBytes``) is read from g
    instead. Counted for a full channel chunk, the largest. ``taps`` from
    ``roi_sample_taps``, ``footprints`` from ``roi_footprints`` -> ((roi,
    tile) pairs, longest list, unstaged pairs, (B, R) bool: the rois with an
    unstaged pair)."""
    conf = roi_align_bwd_config()
    th, tw = conf["tile"]
    lane = conf["chunk"] // 32
    width = -(-min(conf["chunk"], channels) // lane) * lane
    capacity = roi_align_bwd_stage_bytes() // (width * itemsize)  # bins the stage holds
    pairs, longest = roi_tile_pairs(footprints, levels, feature_shapes)
    nonempty = footprints[..., 0] <= footprints[..., 1]
    unstaged, rois = 0, torch.zeros(levels.shape, dtype=torch.bool, device=levels.device)
    for lvl, (h, w) in enumerate(feature_shapes):
        on = nonempty & (levels == lvl)
        if not bool(on.any()):
            continue
        by = _axis_bins(*(t[on] for t in taps[:4]), th, -(-h // th), sampling_ratio)
        bx = _axis_bins(*(t[on] for t in taps[4:]), tw, -(-w // tw), sampling_ratio)
        over = (by[:, :, None] * bx[:, None, :]) > capacity
        unstaged += int(over.sum())
        rois[on] = over.flatten(1).any(1)
    return pairs, longest, unstaged, rois


def _axis_entries(lo: list, hi: list, w_lo: list, w_hi: list, cell: int, s: int) -> list:
    """The terms one axis puts on ``cell``, in the kernel's order (sample
    ascending, lo before hi): (bin, weight) pairs."""
    out = []
    for k in range(len(lo)):
        if lo[k] == cell and w_lo[k] != 0:
            out.append((k // s, w_lo[k]))
        if hi[k] == cell and w_hi[k] != 0:
            out.append((k // s, w_hi[k]))
    return out


def roi_align_bwd_tiles(grad_out: torch.Tensor, feature_shapes: Sequence[tuple[int, int]],
                        rois: torch.Tensor, strides: Sequence[int], levels: torch.Tensor, *,
                        sampling_ratio: int = 2, roi_valid: torch.Tensor | None = None,
                        out_dtype: torch.dtype = torch.float32,
                        tile: tuple[int, int] | None = None) -> tuple[list, int, int]:
    """Plain model of K3's partition: the gradient of each level computed
    tile by tile, each tile from its roi list in roi-index order, each cell's
    terms added in the kernel's order (roi, sample row, lo/hi, sample
    column, lo/hi) as f32 (g / S^2) * (wy * wx), then rounded once to
    ``out_dtype``. Channels never meet in a sum, so the kernel's channel
    chunks do not enter. ``tile`` defaults to the kernel's
    (``roi_align_bwd_config``). Returns (gradients (B, H_l, W_l, C) per
    level, (roi, tile) pairs, longest roi list); the gradients equal autograd
    of ``multilevel_roi_align_plain`` up to the order of the sums."""
    th, tw = tile or roi_align_bwd_config()["tile"]
    b, r, p, _, c = grad_out.shape
    s = sampling_ratio
    dev = grad_out.device
    if roi_valid is None:
        roi_valid = torch.ones((b, r), dtype=torch.bool, device=dev)
    taps = roi_sample_taps(rois, levels, feature_shapes, strides, output_size=p,
                           sampling_ratio=s)
    fp = roi_footprints(taps, roi_valid.bool()).tolist()
    taps = [t.tolist() for t in taps]
    lv = levels.tolist()
    gv = grad_out.float() / torch.tensor(float(s * s), device=dev)
    grads, pairs, longest = [], 0, 0
    for lvl, (h, w) in enumerate(feature_shapes):
        out = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
        for bi in range(b):
            mine = [ri for ri in range(r) if lv[bi][ri] == lvl and fp[bi][ri][0] <= fp[bi][ri][1]]
            for ty0 in range(0, h, th):
                for tx0 in range(0, w, tw):
                    todo = [ri for ri in mine if fp[bi][ri][0] < ty0 + th and ty0 <= fp[bi][ri][1]
                            and fp[bi][ri][2] < tx0 + tw and tx0 <= fp[bi][ri][3]]
                    pairs += len(todo)
                    longest = max(longest, len(todo))
                    acc = torch.zeros((th, tw, c), dtype=torch.float32, device=dev)
                    for ri in todo:
                        y_lo, y_hi, wy_lo, wy_hi, x_lo, x_hi, wx_lo, wx_hi = (
                            t[bi][ri] for t in taps)
                        rows = [_axis_entries(y_lo, y_hi, wy_lo, wy_hi, ty0 + j, s)
                                for j in range(th)]
                        cols = [_axis_entries(x_lo, x_hi, wx_lo, wx_hi, tx0 + j, s)
                                for j in range(tw)]
                        acc = _add_roi_terms(acc, gv[bi, ri], rows, cols)
                    out[bi, ty0:ty0 + th, tx0:tx0 + tw] = acc[:h - ty0, :w - tx0]
        grads.append(out.to(out_dtype))
    return grads, pairs, longest


def _add_roi_terms(acc: torch.Tensor, gv: torch.Tensor, rows: list, cols: list) -> torch.Tensor:
    """acc (th, tw, C) plus one roi's terms: for cell (y, x), row entry i and
    column entry j in (i, j) order, gv[bin_i, bin_j] * (a_i * b_j), each
    product and sum rounded to f32 as the kernel rounds them."""
    dev = acc.device

    def step(entries, i):
        has = torch.tensor([len(e) > i for e in entries], device=dev)
        pick = [e[i] if len(e) > i else (0, 0.0) for e in entries]
        return (has, torch.tensor([q[0] for q in pick], device=dev),
                torch.tensor([q[1] for q in pick], dtype=torch.float32, device=dev))

    for i in range(max(len(e) for e in rows)):
        r_has, r_bin, a = step(rows, i)
        for j in range(max(len(e) for e in cols)):
            c_has, c_bin, bw = step(cols, j)
            ab = a[:, None] * bw[None, :]
            term = gv[r_bin[:, None], c_bin[None, :]] * ab[..., None]
            acc = torch.where((r_has[:, None] & c_has[None, :])[..., None], acc + term, acc)
    return acc
