"""The yardstick's arithmetic: the card's published peaks, the least time of
a piece of work (``bound``), the bytes and operations of the kernels whose
roofline share the benchmark reports, and the model FLOPs of a ResNet body
for ``*_mfu`` (a family module, ``benchmark/families/<family>.py``, adds its
neck and heads). Every count is made from the run's own problems
(shapes, rois, offsets), never from what implements them.

Origins: ``bound``, ``roi_flops``, ``dcn_bound`` and ``dcn_bwd_bound`` are
copies of ``chip_smoke.py``'s ``bound``, ``roi_flops``, ``dcn_bound`` and
``dcn_bwd_bounds`` (``bound`` returns the seconds alone; the DCN backward's
corner count is rewritten on this module's own sample points). The rest is
the benchmark's own.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, f32 outside the tensor
# cores, bf16 on the tensor cores. They assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
FPN_IN = (256, 512, 1024, 2048)


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> float:
    """Least seconds of work moving ``nbytes``, doing ``flops`` f32
    operations and ``tc_flops`` bf16 tensor-core operations, on the
    published peaks: the larger of the bytes' time and the operations'."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS, tc_flops / BF16_TC_FLOPS)


def roi_flops(n_rois: int, p: int, s: int, c: int) -> float:
    """RoIAlign: four taps of a bilinear sample, a multiply and an add each."""
    return float(n_rois) * p * p * s * s * c * 8


def roi_align_fwd_bound(n_rois: int, n_valid: int, touched: int, p: int, c: int,
                        itemsize: int = 2) -> float:
    """K1's least seconds: the touched pyramid pixels read once, the
    (rois, P, P, C) output written once, the rois (16 B), levels (4 B) and
    valid flags (1 B) read once; ``roi_flops`` of the valid rois."""
    nbytes = touched * c * itemsize + n_rois * p * p * c * itemsize + n_rois * 21
    return bound(nbytes, roi_flops(n_valid, p, 2, c))


def roi_align_bwd_bound(n_rois: int, map_pixels: int, p: int, c: int,
                        itemsize: int = 2) -> float:
    """K3's least seconds: the upstream gradient (rois, P, P, C) and the
    rois read once, every pixel of the gradient maps written once;
    ``roi_flops`` of the rois."""
    nbytes = n_rois * p * p * c * itemsize + map_pixels * c * itemsize + n_rois * 21
    return bound(nbytes, roi_flops(n_rois, p, 2, c))


def dcn_bound(b: int, h: int, w: int, c: int, stride: int, bf16: bool = True) -> float:
    """K5's least seconds for one layer, Cin = Cout = c: x, offsets and W
    read once, the output written once; the product's 2 * M * 9 * C * C
    operations on the tensor cores (bf16) or the f32 units, and the
    blend's 7 f32 operations per sampled value."""
    ho, wo = -(-h // stride), -(-w // stride)
    m = b * ho * wo
    size = 2 if bf16 else 4
    nbytes = b * h * w * c * size + m * 18 * 4 + 9 * c * c * size + m * c * size
    gemm, blend = 2.0 * m * 9 * c * c, 7.0 * m * 9 * c
    return bound(nbytes, blend, gemm) if bf16 else bound(nbytes, blend + gemm)


def live_corners(off: torch.Tensor, h: int, w: int, stride: int) -> int:
    """Bilinear corners with a nonzero weight inside the (h, w) map, over
    offsets (B, Ho, Wo, 18) of a 3x3 deformable layer (dilation 1)."""
    b, ho, wo = off.shape[:3]
    o = off.float().reshape(b, ho, wo, 3, 3, 2)
    dev = off.device
    tap = torch.arange(3, dtype=torch.float32, device=dev) - 1.0
    sy = (torch.arange(ho, device=dev) * stride)[:, None, None, None] + tap[:, None] + o[..., 0]
    sx = (torch.arange(wo, device=dev) * stride)[None, :, None, None] + tap + o[..., 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    n = 0
    for yi, xi, wt in ((y0, x0, (1 - ly) * (1 - lx)), (y0, x0 + 1, (1 - ly) * lx),
                       (y0 + 1, x0, ly * (1 - lx)), (y0 + 1, x0 + 1, ly * lx)):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        n += int(((wt != 0) & inb).sum())
    return n


def dcn_bwd_bound(off: torch.Tensor, h: int, w: int, c: int, stride: int,
                  bf16: bool = True) -> float:
    """K6's plus K7's least seconds on these offsets, Cin = Cout = c. K6
    reads x, the offsets, dpatch and g once and writes dW (f32) and
    doffsets once, does about 21 f32 operations per sampled value and the
    product's 2 * M * 9c * c on the tensor cores; K7 reads dpatch and the
    offsets and writes an f32 dx once, and does a multiply and an add for
    each channel of each live corner."""
    b, ho, wo = off.shape[:3]
    m = b * ho * wo
    size = 2 if bf16 else 4
    k6_bytes = (b * h * w * c * size + m * 18 * 4 + m * 9 * c * size + m * c * size
                + 9 * c * c * 4 + m * 18 * 4)
    gemm = 2.0 * m * 9 * c * c
    k6 = bound(k6_bytes, 21.0 * m * 9 * c, gemm) if bf16 else bound(k6_bytes, 21.0 * m * 9 * c + gemm)
    k7 = bound(m * 9 * c * size + m * 18 * 4 + b * h * w * c * 4,
               2.0 * live_corners(off, h, w, stride) * c)
    return k6 + k7


def dcn_layers(m: dict, canvas: tuple) -> list:
    """(h, w, c, stride) of each deformable layer's input, in order."""
    out, h, w = [], -(-canvas[0] // 4), -(-canvas[1] // 4)
    dcn = m["backbone"]["dcn_stages"]
    for s, (n, width) in enumerate(zip(STAGE_BLOCKS[m["backbone"]["depth"]], STAGE_WIDTHS)):
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            if dcn[s]:
                out.append((h, w, width, stride))
            if stride == 2 and b == 0:
                h, w = -(-h // 2), -(-w // 2)
    return out


def conv_flops(cin: int, cout: int, k: int, ho: int, wo: int) -> float:
    return 2.0 * cin * cout * k * k * ho * wo


def resnet_flops(m: dict, canvas: tuple) -> tuple:
    """Model FLOPs (a multiply-add counted as 2) of the ResNet body of one
    image's forward pass at ``canvas`` (H, W): the stem and every conv of
    every block (a deformable layer as its 3x3 product, its offset conv
    beside it) -> (FLOPs, [(H, W) of C2-C5])."""
    H, W = canvas
    h, w = -(-H // 2), -(-W // 2)
    f = conv_flops(3, 64, 7, h, w)
    h, w = -(-h // 2), -(-w // 2)
    cin, sizes = 64, []
    dcn = m["backbone"]["dcn_stages"]
    for s, (n, width) in enumerate(zip(STAGE_BLOCKS[m["backbone"]["depth"]], STAGE_WIDTHS)):
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            ho, wo = -(-h // stride), -(-w // stride)
            f += conv_flops(cin, width, 1, h, w)
            f += conv_flops(width, width, 3, ho, wo)
            if dcn[s]:
                f += conv_flops(width, 18, 3, ho, wo)
            f += conv_flops(width, 4 * width, 1, ho, wo)
            if stride != 1 or cin != 4 * width:
                f += conv_flops(cin, 4 * width, 1, ho, wo)
            cin, h, w = 4 * width, ho, wo
        sizes.append((h, w))
    return f, sizes


def touched_pixels(rois: torch.Tensor, valid: torch.Tensor, level_hw: list, m: dict) -> int:
    """Pyramid pixels that RoIAlign reads with a nonzero weight for these
    rois (B, R, 4) and valid flags (B, R), over the levels' (H, W), finest
    first: the bilinear corners of every sample of every valid roi on its
    FPN level, counted once."""
    r = m["roi"]
    b, n = rois.shape[:2]
    dev = rois.device
    w = (rois[..., 2] - rois[..., 0]).clamp(min=1e-6)
    h = (rois[..., 3] - rois[..., 1]).clamp(min=1e-6)
    k = torch.floor(r["canonical_level"] + torch.log2(torch.sqrt(w * h) / r["canonical_scale"]))
    lv = (k.clamp(r["min_level"], r["max_level"]) - r["min_level"]).long()
    hs = torch.tensor([x[0] for x in level_hw], device=dev)[lv]
    ws = torch.tensor([x[1] for x in level_hw], device=dev)[lv]
    base = torch.tensor([0] + [x[0] * x[1] for x in level_hw[:-1]], device=dev).cumsum(0)[lv]
    total = sum(x[0] * x[1] for x in level_hw)
    base = base + torch.arange(b, device=dev)[:, None] * total
    sc = 1.0 / (2.0 ** (lv + r["min_level"])).float()
    x1, y1 = rois[..., 0] * sc, rois[..., 1] * sc
    rw = (rois[..., 2] * sc - x1).clamp(min=1.0)
    rh = (rois[..., 3] * sc - y1).clamp(min=1.0)
    p, s = r["output_size"], r["sampling_ratio"]
    frac = (torch.arange(p, device=dev, dtype=torch.float32)[:, None]
            + (torch.arange(s, device=dev, dtype=torch.float32)[None, :] + 0.5) / s).reshape(-1)
    ys = y1[..., None] + frac * (rh / p)[..., None]
    xs = x1[..., None] + frac * (rw / p)[..., None]

    def corners(coord, size):
        size = size.float()[..., None]
        inside = (coord >= -1.0) & (coord <= size)
        cc = torch.minimum(coord.clamp(min=0.0), size - 1.0)
        lo = torch.floor(cc)
        hi = torch.minimum(lo + 1.0, size - 1.0)
        frac_ = cc - lo
        return ((lo.long(), inside & (frac_ < 1.0)), (hi.long(), inside & (frac_ > 0.0)))

    ids = []
    for yi, ym in corners(ys, hs):
        for xi, xm in corners(xs, ws):
            idx = base[..., None, None] + yi[..., :, None] * ws[..., None, None] + xi[..., None, :]
            keep = ym[..., :, None] & xm[..., None, :] & valid[..., None, None]
            ids.append(idx[keep])
    return int(torch.unique(torch.cat(ids)).numel())
