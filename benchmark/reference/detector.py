"""Plain-PyTorch reference of the two benchmarked detectors, in float32.

A frozen copy of the R-CNN family's mathematics (Faster R-CNN R50-FPN and
Cascade R-CNN R101 with deformable convs in stages c3-c5), written with
plain torch operations only: no custom operator, no kernel, no import of the
measured program or of JAX. It reads its hyperparameters from the ``model``
section of a configuration file (``benchmark/configs/<config>.json``) and
its weights from a plain ``{name: tensor}`` dict whose names are those of
``param_specs``.

Layouts: images and maps NHWC where the detector's public functions use
them (the transform, RoIAlign, the deformable sampling), NCHW inside the
convolutions. Every conv, linear and deformable product runs through a
``Precision`` object: ``F32`` computes in float32 (TF32 must be off, which
``float32_exact`` sets), ``FP8`` rounds each product's two operands to
float8 e4m3 (a per-tensor scale) first: the control that has to fail the
comparison.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)
FPN_IN = (256, 512, 1024, 2048)
WH_CLIP = 4.135166556742356  # log(1000 / 16)
F32_EPS = float(torch.finfo(torch.float32).eps)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Precision:
    """The operands of every product, as the reference computes them."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()


class Float8(Precision):
    """float8 e4m3 operands with a per-tensor scale (its largest magnitude
    mapped to 448), products and sums in float32."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        s = t.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s


F32 = Precision()
FP8 = Float8()


# ---------------------------------------------------------------- parameters


def blocks(m: dict) -> list:
    """[(stage, block, in_channels, width, stride, dcn)] of the ResNet."""
    out, cin = [], 64
    dcn = m["backbone"]["dcn_stages"]
    for s, (n, w) in enumerate(zip(STAGE_BLOCKS[m["backbone"]["depth"]], STAGE_WIDTHS)):
        for b in range(n):
            out.append((s, b, cin, w, 2 if (s > 0 and b == 0) else 1, bool(dcn[s])))
            cin = w * 4
    return out


def num_stages(m: dict) -> int:
    return m["cascade"]["num_stages"] if m.get("cascade") else 1


def class_agnostic(m: dict) -> bool:
    return bool(m.get("cascade")) or m["bbox_head"]["class_agnostic"]


def param_specs(m: dict) -> list:
    """[(name, shape, kind)] of every weight the detector reads. ``kind``
    names the initialiser family: conv (he normal), offset (the deformable
    offset convs), bn_gamma / bn_gamma_last / bn_beta / bn_mean / bn_var
    (FrozenBN), fpn (xavier), fpn_bias, rpn, rpn_bias, fc (xavier),
    fc_bias, cls, cls_bias, bbox, bbox_bias."""
    specs = [("backbone.stem_conv.weight", (64, 3, 7, 7), "conv")]
    bn = lambda p, c, last=False: [  # noqa: E731
        (f"{p}.gamma", (c,), "bn_gamma_last" if last else "bn_gamma"), (f"{p}.beta", (c,), "bn_beta"),
        (f"{p}.mean", (c,), "bn_mean"), (f"{p}.var", (c,), "bn_var")]
    specs += bn("backbone.stem_bn", 64)
    for s, b, cin, w, stride, dcn in blocks(m):
        p = f"backbone.layer{s + 1}_block{b}"
        specs.append((f"{p}.conv1.weight", (w, cin, 1, 1), "conv"))
        specs += bn(f"{p}.bn1", w)
        if dcn:
            specs += [(f"{p}.conv2.offset_conv.weight", (18, w, 3, 3), "offset"),
                      (f"{p}.conv2.offset_conv.bias", (18,), "offset_bias"),
                      (f"{p}.conv2.weight", (w, w, 3, 3), "conv")]
        else:
            specs.append((f"{p}.conv2.weight", (w, w, 3, 3), "conv"))
        specs += bn(f"{p}.bn2", w)
        specs.append((f"{p}.conv3.weight", (4 * w, w, 1, 1), "conv"))
        specs += bn(f"{p}.bn3", 4 * w, last=True)
        if stride != 1 or cin != 4 * w:
            specs.append((f"{p}.downsample_conv.weight", (4 * w, cin, 1, 1), "conv"))
            specs += bn(f"{p}.downsample_bn", 4 * w)
    c = m["fpn"]["out_channels"]
    for lv in range(m["fpn"]["min_level"], min(m["fpn"]["max_level"], 5) + 1):
        specs += [(f"fpn.lateral_p{lv}.weight", (c, FPN_IN[lv - 2], 1, 1), "fpn"),
                  (f"fpn.lateral_p{lv}.bias", (c,), "fpn_bias"),
                  (f"fpn.smooth_p{lv}.weight", (c, c, 3, 3), "fpn"),
                  (f"fpn.smooth_p{lv}.bias", (c,), "fpn_bias")]
    a = len(m["rpn"]["anchor"]["scales"]) * len(m["rpn"]["anchor"]["ratios"])
    specs += [("rpn.rpn_conv.weight", (c, c, 3, 3), "rpn"), ("rpn.rpn_conv.bias", (c,), "rpn_bias"),
              ("rpn.rpn_cls.weight", (a, c, 1, 1), "rpn"), ("rpn.rpn_cls.bias", (a,), "rpn_bias"),
              ("rpn.rpn_reg.weight", (4 * a, c, 1, 1), "rpn"),
              ("rpn.rpn_reg.bias", (4 * a,), "rpn_bias")]
    p, fc, k = m["roi"]["output_size"], m["bbox_head"]["fc_channels"], m["bbox_head"]["num_classes"]
    nb = 4 if class_agnostic(m) else 4 * (k + 1)
    for i in range(num_stages(m)):
        h = f"bbox_head{i}"
        specs += [(f"{h}.fc1.weight", (fc, p * p * c), "fc"), (f"{h}.fc1.bias", (fc,), "fc_bias"),
                  (f"{h}.fc2.weight", (fc, fc), "fc"), (f"{h}.fc2.bias", (fc,), "fc_bias"),
                  (f"{h}.cls_score.weight", (k + 1, fc), "cls"),
                  (f"{h}.cls_score.bias", (k + 1,), "cls_bias"),
                  (f"{h}.bbox_pred.weight", (nb, fc), "bbox"),
                  (f"{h}.bbox_pred.bias", (nb,), "bbox_bias")]
    return specs


# ---------------------------------------------------------------- boxes


def box_area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0.0) * (b[..., 3] - b[..., 1]).clamp(min=0.0)


def pairwise_iou(b1, b2):
    a1, a2 = box_area(b1), box_area(b2)
    lt = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    rb = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def encode_boxes(rois, gt, stds):
    ex_w, ex_h = rois[..., 2] - rois[..., 0], rois[..., 3] - rois[..., 1]
    ex_cx, ex_cy = rois[..., 0] + 0.5 * ex_w, rois[..., 1] + 0.5 * ex_h
    gt_w, gt_h = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    gt_cx, gt_cy = gt[..., 0] + 0.5 * gt_w, gt[..., 1] + 0.5 * gt_h
    ex_w, ex_h = ex_w.clamp(min=1e-6), ex_h.clamp(min=1e-6)
    d = torch.stack([(gt_cx - ex_cx) / ex_w, (gt_cy - ex_cy) / ex_h,
                     torch.log(gt_w.clamp(min=1e-6) / ex_w), torch.log(gt_h.clamp(min=1e-6) / ex_h)], -1)
    return d / torch.tensor(stds, dtype=d.dtype, device=d.device)


def decode_boxes(rois, deltas, stds):
    shape = deltas.shape
    d = deltas.reshape(*shape[:-1], -1, 4) * torch.tensor(stds, dtype=deltas.dtype,
                                                          device=deltas.device)
    w, h = rois[..., 2] - rois[..., 0], rois[..., 3] - rois[..., 1]
    cx, cy = rois[..., 0] + 0.5 * w, rois[..., 1] + 0.5 * h
    dx, dy, dw, dh = d.unbind(-1)
    dw, dh = dw.clamp(max=WH_CLIP), dh.clamp(max=WH_CLIP)
    pcx, pcy = dx * w[..., None] + cx[..., None], dy * h[..., None] + cy[..., None]
    pw, ph = torch.exp(dw) * w[..., None], torch.exp(dh) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)
    return out.reshape(shape)


def clip_boxes(boxes, im_hw):
    h, w = im_hw[..., 0], im_hw[..., 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], -1)


def flip_boxes(boxes, im_w):
    return torch.stack([im_w - boxes[..., 2], boxes[..., 1], im_w - boxes[..., 0], boxes[..., 3]], -1)


# ---------------------------------------------------------------- transform


def resample_weights(n_in: int, n_out: int, scale, translation):
    """(B, n_in, n_out) antialiased triangle-kernel weights (the port's
    ``scale_and_translate`` resample, ``method="linear"``)."""
    dev = scale.device
    inv = (torch.ones_like(scale) / scale)[:, None, None]
    kscale = torch.clamp(inv, min=1.0)
    o = torch.arange(n_out, dtype=torch.float32, device=dev)
    i = torch.arange(n_in, dtype=torch.float32, device=dev)
    sf = (o[None, None, :] + 0.5) * inv - translation[:, None, None] * inv - 0.5
    x = (sf - i[None, :, None]).abs() / kscale
    wts = (1.0 - x.abs()).clamp(min=0.0)
    tot = wts.sum(dim=1, keepdim=True)
    wts = torch.where(tot.abs() > 1000.0 * F32_EPS,
                      wts / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(wts))
    inside = (sf >= -0.5) & (sf <= n_in - 0.5)
    return torch.where(inside, wts, torch.zeros_like(wts))


def transform(raw, hw, flip, gt_boxes, m: dict, out_hw):
    """uint8 canvases (B, h, w, 3) -> (images (B, H, W, 3) f32, gt boxes in
    network coordinates, im_info (B, 3): orig h, orig w, scale)."""
    d = m["data"]
    b, raw_h, raw_w, _ = raw.shape
    oh, ow = out_hw
    h, w = hw[:, 0].float(), hw[:, 1].float()
    full = lambda v: torch.full_like(h, float(v))  # noqa: E731
    scale = torch.minimum(full(d["scale"]) / torch.minimum(h, w), full(d["max_size"]) / torch.maximum(h, w))
    scale = torch.minimum(scale, torch.minimum(full(oh) / h, full(ow) / w))
    nh, nw = h * scale, w * scale
    x = torch.where(flip[:, None, None, None], raw.flip(2), raw).float()
    tx = torch.where(flip, torch.round(nw) - scale * raw_w, torch.zeros_like(scale))
    wy = resample_weights(raw_h, oh, scale, torch.zeros_like(scale))
    wx = resample_weights(raw_w, ow, scale, tx)
    x = torch.einsum("bhwc,bhH->bHwc", x, wy)
    x = torch.einsum("bHwc,bwW->bHWc", x, wx)
    yy = torch.arange(oh, dtype=torch.float32, device=raw.device)
    xx = torch.arange(ow, dtype=torch.float32, device=raw.device)
    valid = (yy[None, :, None] < nh[:, None, None]) & (xx[None, None, :] < nw[:, None, None])
    mean = torch.tensor(d["mean"], dtype=torch.float32, device=raw.device)
    std = torch.tensor(d["std"], dtype=torch.float32, device=raw.device)
    x = torch.where(valid[..., None], (x - mean) / std, torch.zeros_like(x))
    gb = gt_boxes.float() * scale[:, None, None]
    gb = torch.where(flip[:, None, None], flip_boxes(gb, nw[:, None]), gb)
    return x, gb, torch.stack([h, w, scale], 1)


# ---------------------------------------------------------------- network


def frozen_bn(x, W, p):
    scale = W[f"{p}.gamma"] * torch.rsqrt(W[f"{p}.var"] + 1e-5)
    bias = W[f"{p}.beta"] - W[f"{p}.mean"] * scale
    return x * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def conv(x, W, name, prec, stride=1, padding=None, bias=False):
    w = W[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(prec.q(x), prec.q(w), W[f"{name}.bias"] if bias else None, stride, pad)


def dcn_corners(shape, offsets, stride):
    """Sample points of the 3x3 deformable im2col on a (B, H, W) map (the
    port's ``_corners``): ly, lx and the four corners' (flat row, inside)."""
    b, h, w = shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    dev = offsets.device
    off = offsets.float().reshape(b, ho, wo, 3, 3, 2)
    oy = torch.arange(ho, dtype=torch.float32, device=dev) * stride
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * stride
    tap = torch.arange(3, dtype=torch.float32, device=dev) - 1.0
    sy = oy[:, None, None, None] + tap[None, None, :, None] + off[..., 0]
    sx = ox[None, :, None, None] + tap[None, None, None, :] + off[..., 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    img = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1, 1)
    corners = []
    for yi, xi in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        rows = img + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        corners.append((rows, inb.float()))
    return sy - y0, sx - x0, corners


def deform_conv(x, offsets, weight, stride, prec):
    """x (B, C, H, W), offsets (B, 18, Ho, Wo), weight (Cout, C, 3, 3) ->
    (B, Cout, Ho, Wo): bilinear patches (zero outside the map), then one
    product."""
    xh = x.permute(0, 2, 3, 1)
    b, h, w, c = xh.shape
    off = offsets.permute(0, 2, 3, 1)
    ly, lx, corners = dcn_corners((b, h, w), off, stride)
    flat = xh.reshape(b * h * w, c)
    wts = ((1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx)
    acc = None
    for (rows, inb), wt in zip(corners, wts):
        v = flat[rows] * (wt * inb)[..., None]
        acc = v if acc is None else acc + v
    patches = acc.reshape(*acc.shape[:3], 9 * c)
    wm = weight.permute(2, 3, 1, 0).reshape(9 * c, -1)
    out = torch.matmul(prec.q(patches), prec.q(wm))
    return out.permute(0, 3, 1, 2)


def backbone(img, W, m: dict, prec, on_dcn=None):
    """images (B, H, W, 3) -> [C2, C3, C4, C5] NCHW. ``on_dcn(name, x)``
    is called with each deformable layer's input before its offsets are
    computed (the weight recipe's calibration)."""
    x = img.permute(0, 3, 1, 2)
    x = F.relu(frozen_bn(conv(x, W, "backbone.stem_conv", prec, 2, 3), W, "backbone.stem_bn"))
    frozen = m["backbone"]["frozen_stages"]
    if frozen >= 0:
        x = x.detach()
    x = F.max_pool2d(x, 3, 2, 1)
    outs, last = [], blocks(m)
    for i, (s, b, cin, w, stride, dcn) in enumerate(last):
        p = f"backbone.layer{s + 1}_block{b}"
        o = F.relu(frozen_bn(conv(x, W, f"{p}.conv1", prec), W, f"{p}.bn1"))
        if dcn:
            if on_dcn is not None:
                on_dcn(p, o)
            offs = F.conv2d(prec.q(o) if prec is not F32 else o, prec.q(W[f"{p}.conv2.offset_conv.weight"]),
                            W[f"{p}.conv2.offset_conv.bias"], stride, 1)
            o = deform_conv(o, offs, W[f"{p}.conv2.weight"], stride, prec)
        else:
            o = conv(o, W, f"{p}.conv2", prec, stride)
        o = F.relu(frozen_bn(o, W, f"{p}.bn2"))
        o = frozen_bn(conv(o, W, f"{p}.conv3", prec), W, f"{p}.bn3")
        r = x
        if f"{p}.downsample_conv.weight" in W:
            r = frozen_bn(conv(x, W, f"{p}.downsample_conv", prec, stride, 0), W, f"{p}.downsample_bn")
        x = F.relu(o + r)
        if i + 1 == len(last) or last[i + 1][0] != s:
            if s + 1 <= frozen:
                x = x.detach()
            outs.append(x)
    return outs


def fpn(feats, W, m: dict, prec):
    lo, hi = m["fpn"]["min_level"], min(m["fpn"]["max_level"], 5)
    c = {i + 2: f for i, f in enumerate(feats)}
    lat = {lv: conv(c[lv], W, f"fpn.lateral_p{lv}", prec, bias=True) for lv in range(lo, hi + 1)}
    for lv in range(hi - 1, lo - 1, -1):
        lat[lv] = lat[lv] + F.interpolate(lat[lv + 1], scale_factor=2, mode="nearest")
    outs = [conv(lat[lv], W, f"fpn.smooth_p{lv}", prec, bias=True) for lv in range(lo, hi + 1)]
    if m["fpn"]["max_level"] >= 6:
        outs.append(outs[-1][:, :, ::2, ::2])
    return outs


def rpn_head(pyr, W, prec):
    """-> ([(B, H, W, A)], [(B, H, W, 4A)]) per level."""
    cls, reg = [], []
    for f in pyr:
        x = F.relu(conv(f, W, "rpn.rpn_conv", prec, bias=True))
        cls.append(conv(x, W, "rpn.rpn_cls", prec, bias=True).permute(0, 2, 3, 1))
        reg.append(conv(x, W, "rpn.rpn_reg", prec, bias=True).permute(0, 2, 3, 1))
    return cls, reg


def level_anchors(m: dict, pad_hw, device) -> list:
    a = m["rpn"]["anchor"]
    out = []
    for s in a["strides"]:
        fh, fw = -(-pad_hw[0] // s), -(-pad_hw[1] // s)
        base = []
        for ratio in a["ratios"]:
            w0 = np.sqrt(float(s) * s / ratio)
            h0 = w0 * ratio
            for sc in a["scales"]:
                w, h = w0 * sc, h0 * sc
                base.append([s / 2.0 - 0.5 * w, s / 2.0 - 0.5 * h, s / 2.0 + 0.5 * w, s / 2.0 + 0.5 * h])
        base = np.asarray(base, np.float32)
        sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * s, np.arange(fh, dtype=np.float32) * s)
        shifts = np.stack([sx, sy, sx, sy], -1)
        out.append(torch.from_numpy((shifts[:, :, None] + base[None, None]).reshape(-1, 4)).to(device))
    return out


# ---------------------------------------------------------------- NMS, proposals


def sort_desc(x):
    return torch.sort(x, dim=-1, descending=True, stable=True)


def nms_keep_sorted(boxes, valid, thr):
    """Greedy keep mask of score-sorted problems (P, N, 4), (P, N)."""
    n = boxes.shape[-2]
    over = pairwise_iou(boxes.float(), boxes.float()) > thr
    later = torch.arange(n, device=boxes.device)
    keep = valid.clone()
    for i in range(n):
        keep &= ~(keep[:, i, None] & (later > i) & over[:, i, :])
    return keep


def nms_mask(boxes, scores, thr, valid):
    lead, n = scores.shape[:-1], scores.shape[-1]
    _, order = sort_desc(scores)
    bs = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    vs = torch.gather(valid, -1, order)
    ks = nms_keep_sorted(bs.reshape(-1, n, 4), vs.reshape(-1, n), thr)
    return torch.zeros_like(vs).scatter_(-1, order, ks.reshape(*lead, n))


def select_top(boxes, masked, keep, max_out):
    s = torch.where(keep, masked, torch.full_like(masked, -float("inf")))
    n = s.shape[-1]
    if max_out > n:
        s = torch.cat([s, s.new_full((*s.shape[:-1], max_out - n), -float("inf"))], -1)
    top, idx = sort_desc(s)
    top, idx = top[..., :max_out], idx[..., :max_out].clamp(max=n - 1)
    ok = top > -float("inf")
    ob = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    return idx, torch.where(ok[..., None], ob, torch.zeros_like(ob)), torch.where(ok, top, 0.0), ok


def proposals(cls, reg, anchors, image_hw, pre_n, post_n, thr, stds):
    """Per-level top-k, decode, clip, NMS, merged top-k -> (rois, valid)."""
    b = image_hw.shape[0]
    ks = [min(pre_n, c[0].numel()) for c in cls]
    n = max(ks)
    lb, ls, lo = [], [], []
    for c, r, an, k in zip(cls, reg, anchors, ks):
        sc, idx = sort_desc(c.reshape(b, -1).float())
        sc, idx = sc[:, :k], idx[:, :k]
        d = torch.gather(r.reshape(b, -1, 4).float(), 1, idx[..., None].expand(b, k, 4))
        bx = clip_boxes(decode_boxes(an[idx], d, stds), image_hw[:, None, :])
        ok = (bx[..., 2] - bx[..., 0] > 0) & (bx[..., 3] - bx[..., 1] > 0)
        if k < n:
            bx = torch.cat([bx, bx.new_zeros(b, n - k, 4)], 1)
            sc = torch.cat([sc, sc.new_full((b, n - k), -float("inf"))], 1)
            ok = torch.cat([ok, ok.new_zeros(b, n - k)], 1)
        lb.append(bx)
        ls.append(sc)
        lo.append(ok)
    boxes, scores, valid = torch.stack(lb, 1), torch.stack(ls, 1), torch.stack(lo, 1)
    masked = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    keep = nms_mask(boxes, masked, thr, valid)
    _, nb, ns, nv = select_top(boxes, masked, keep, min(post_n, n))
    allb = nb.reshape(b, -1, 4)
    alls = torch.where(nv, ns, torch.full_like(ns, -float("inf"))).reshape(b, -1)
    k = min(post_n, sum(min(post_n, kl) for kl in ks))
    top, idx = sort_desc(alls)
    top, idx = top[:, :k], idx[:, :k]
    ok = top > -float("inf")
    rois = torch.gather(allb, 1, idx[..., None].expand(b, k, 4))
    return torch.where(ok[..., None], rois, torch.zeros_like(rois)), ok


# ---------------------------------------------------------------- RoIAlign


def roi_align(pyr, rois, valid, m: dict, out_size: int):
    """Multilevel RoIAlign (aligned=False) over P2..P5 NCHW maps: rois
    (B, R, 4) -> (B, R, P, P, C) f32."""
    r = m["roi"]
    feats = [f.permute(0, 2, 3, 1) for f in pyr[: r["max_level"] - r["min_level"] + 1]]
    b, nr = rois.shape[:2]
    c, dev = feats[0].shape[-1], rois.device
    rois = rois.float()
    w = (rois[..., 2] - rois[..., 0]).clamp(min=1e-6)
    h = (rois[..., 3] - rois[..., 1]).clamp(min=1e-6)
    k = torch.floor(r["canonical_level"] + torch.log2(torch.sqrt(w * h) / r["canonical_scale"]))
    lv = (k.clamp(r["min_level"], r["max_level"]) - r["min_level"]).long()
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    strides = [2 ** (r["min_level"] + i) for i in range(len(feats))]
    flat = torch.cat([f.reshape(b, -1, c) for f in feats], 1)
    total = flat.shape[1]
    flat = flat.reshape(b * total, c)
    offs = np.cumsum([0] + [fh * fw for fh, fw in sizes[:-1]]).tolist()
    h_arr = torch.tensor([s[0] for s in sizes], device=dev)[lv]
    w_arr = torch.tensor([s[1] for s in sizes], device=dev)[lv]
    st = torch.tensor([float(s) for s in strides], device=dev)[lv]
    base = (torch.tensor(offs, device=dev)[lv] + torch.arange(b, device=dev)[:, None] * total)
    sc = 1.0 / st
    x1, y1 = rois[..., 0] * sc, rois[..., 1] * sc
    rw = (rois[..., 2] * sc - x1).clamp(min=1.0)
    rh = (rois[..., 3] * sc - y1).clamp(min=1.0)
    p, s = out_size, r["sampling_ratio"]
    p_t, s_t = torch.tensor(float(p), device=dev), torch.tensor(float(s), device=dev)
    frac = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s_t).reshape(-1)
    ys = y1[..., None] + frac * (rh / p_t)[..., None]
    xs = x1[..., None] + frac * (rw / p_t)[..., None]

    def taps(coord, size):
        size_f = size.float()[..., None]
        inside = (coord >= -1.0) & (coord <= size_f)
        cc = torch.minimum(coord.clamp(min=0.0), size_f - 1.0)
        lo = torch.floor(cc)
        hi = torch.minimum(lo + 1.0, size_f - 1.0)
        hw_ = cc - lo
        z = torch.zeros_like(hw_)
        return lo.long(), hi.long(), torch.where(inside, 1.0 - hw_, z), torch.where(inside, hw_, z)

    ylo, yhi, wylo, wyhi = taps(ys, h_arr)
    xlo, xhi, wxlo, wxhi = taps(xs, w_arr)
    bb, wr = base[..., None, None], w_arr[..., None, None]
    g = lambda yi, xi: flat[bb + yi[..., :, None] * wr + xi[..., None, :]]  # noqa: E731
    val = (g(ylo, xlo) * (wylo[..., :, None] * wxlo[..., None, :])[..., None]
           + g(ylo, xhi) * (wylo[..., :, None] * wxhi[..., None, :])[..., None]
           + g(yhi, xlo) * (wyhi[..., :, None] * wxlo[..., None, :])[..., None]
           + g(yhi, xhi) * (wyhi[..., :, None] * wxhi[..., None, :])[..., None])
    out = val.reshape(b, nr, p, s, p, s, c).mean(dim=(3, 5))
    return torch.where(valid[..., None, None, None], out, torch.zeros_like(out))


def bbox_head(feats, W, i: int, prec):
    """(R, P, P, C) -> (cls logits (R, K+1), deltas (R, 4 or 4(K+1)))."""
    h = f"bbox_head{i}"
    x = feats.reshape(feats.shape[0], -1)
    lin = lambda x, n: F.linear(prec.q(x), prec.q(W[f"{h}.{n}.weight"]), W[f"{h}.{n}.bias"])  # noqa: E731
    x = F.relu(lin(x, "fc1"))
    x = F.relu(lin(x, "fc2"))
    return lin(x, "cls_score"), lin(x, "bbox_pred")


def stage_stds(m: dict, i: int):
    return m["cascade"]["stage_bbox_stds"][i] if m.get("cascade") else m["bbox_head"]["bbox_stds"]


# ---------------------------------------------------------------- inference


def second_stage(pyr, rois, valid, resized_hw, W, m: dict, prec, forced=None):
    """The R-CNN stages over given first-stage rois: -> (last stage's rois,
    mean of the stages' softmaxes, last stage's deltas, every stage's
    deltas). A cascade stage's rois are decoded from the stage before's
    deltas, or from ``forced[i]`` (B, R, 4) where given."""
    b = rois.shape[0]
    n = num_stages(m)
    probs, all_deltas = None, []
    for i in range(n):
        f = roi_align(pyr, rois, valid, m, m["roi"]["output_size"])
        s = f.shape[1]
        cl, dl = bbox_head(f.reshape(b * s, *f.shape[2:]), W, i, prec)
        dl = dl.reshape(b, s, -1)
        all_deltas.append(dl)
        p = torch.softmax(cl.reshape(b, s, -1), -1)
        probs = p if probs is None else probs + p
        if i + 1 < n:
            d = dl if forced is None else forced[i].float()
            rois = clip_boxes(decode_boxes(rois, d, stage_stds(m, i)), resized_hw[:, None, :])
    return rois, probs / n, dl, all_deltas


def candidates(rois, probs, deltas, im_info, m: dict):
    """The postprocess's decoded candidates: (boxes (B, R*K, 4) in network
    coordinates, scores (B, R*K) masked by nothing, labels (R*K,))."""
    k = m["bbox_head"]["num_classes"]
    b, r = rois.shape[:2]
    stds = stage_stds(m, num_stages(m) - 1)
    rh = (im_info[:, :2] * im_info[:, 2:3])[:, None, None, :]
    if class_agnostic(m):
        bx = clip_boxes(decode_boxes(rois, deltas, stds), rh[:, 0])
        bpc = bx[:, :, None, :].expand(b, r, k, 4)
    else:
        d = deltas.reshape(b, r, k + 1, 4)
        bpc = clip_boxes(decode_boxes(rois[:, :, None, :].expand(b, r, k + 1, 4), d, stds), rh)[:, :, 1:]
    return bpc.reshape(b, r * k, 4), probs[..., 1:].reshape(b, r * k), \
        torch.arange(k, device=rois.device).repeat(r)


def postprocess(rois, valid, probs, deltas, im_info, m: dict):
    """Decode, top-k, class-aware greedy NMS, threshold -> detections in
    original-image coordinates and, for each, its candidate index (roi *
    num_classes + class) or -1."""
    t = m["test"]
    k_cls = m["bbox_head"]["num_classes"]
    b, r = rois.shape[:2]
    boxes, scores, labels = candidates(rois, probs, deltas, im_info, m)
    scores = torch.where(valid[..., None].expand(b, r, k_cls).reshape(b, -1), scores,
                         torch.zeros_like(scores))
    k = min(t["pre_nms_per_class"], scores.shape[1])
    top, idx = sort_desc(scores)
    top, idx = top[:, :k], idx[:, :k]
    cb = torch.gather(boxes, 1, idx[..., None].expand(b, k, 4))
    cl = labels[idx]
    ok = top > t["score_thr"]
    safe = torch.where(ok[..., None], cb, torch.zeros_like(cb))
    off = torch.nan_to_num(safe.amax(dim=(-2, -1), keepdim=True), nan=0.0, posinf=0.0, neginf=0.0) + 1.0
    shifted = cb + cl.to(cb.dtype)[..., None] * off
    masked = torch.where(ok, top, torch.full_like(top, -float("inf")))
    keep = nms_mask(shifted, masked, t["nms_thr"], ok)
    sel, ob, os_, ov = select_top(cb, masked, keep, t["max_per_image"])
    ol = torch.where(ov, torch.gather(cl, -1, sel), torch.full_like(sel, -1))
    src = torch.where(ov, torch.gather(idx, -1, sel), torch.full_like(sel, -1))
    scale = im_info[:, 2][:, None, None]
    ob = clip_boxes(ob / scale, im_info[:, None, :2])
    return {"boxes": ob, "scores": os_, "labels": ol, "valid": ov, "source": src}


# ---------------------------------------------------------------- training


def max_iou_rows(boxes, gt, gt_valid):
    iou = pairwise_iou(boxes, gt).masked_fill_(~gt_valid[:, None, :], -1.0)
    return iou.max(dim=-1)


def assign_anchors(anchors, gt, gt_valid, box_valid, pos_thr, neg_thr):
    """Max-IoU anchor assignment with the low-quality force: -> (matched
    (B, N), labels (B, N): -2 outside, -1 ignore, 0 negative, 1 positive)."""
    iou = pairwise_iou(anchors, gt).masked_fill_(~gt_valid[:, None, :], -1.0)
    max_iou, matched = iou.max(dim=-1)
    labels = torch.full(max_iou.shape, -1, dtype=torch.int32, device=iou.device)
    labels = torch.where(max_iou < neg_thr, 0, labels).to(torch.int32)
    labels = torch.where(max_iou >= pos_thr, 1, labels).to(torch.int32)
    best = iou.amax(dim=1)
    is_best = (iou >= (best - 1e-7)[:, None, :]) & (iou > 0.0) & gt_valid[:, None, :]
    ids = torch.arange(iou.shape[-1], dtype=torch.int32, device=iou.device)
    forced = torch.where(is_best, ids, -1).amax(dim=-1)
    force = is_best.any(dim=-1)
    labels = torch.where(force, 1, labels).to(torch.int32)
    matched = torch.where(force, forced.to(matched.dtype), matched)
    no_gt = ~gt_valid.any(dim=-1, keepdim=True)
    labels = torch.where(no_gt & (labels != -2), 0, labels).to(torch.int32)
    labels = torch.where(box_valid, labels, -2).to(torch.int32)
    return matched, labels


def stable_rank(pri):
    order = torch.argsort(pri, dim=-1, stable=True)
    pos = torch.arange(pri.shape[-1], device=pri.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def subsample(labels, num, frac, ranks):
    is_pos, is_neg = labels == 1, labels == 0
    npos = is_pos.sum(-1, keepdim=True).clamp(max=int(num * frac))
    keep_pos = is_pos & (stable_rank(torch.where(is_pos, ranks[0], 2.0)) < npos)
    nneg = torch.minimum(is_neg.sum(-1, keepdim=True), num - npos)
    keep_neg = is_neg & (stable_rank(torch.where(is_neg, ranks[1], 2.0)) < nneg)
    return keep_pos | keep_neg, keep_pos


def sample_rois(props, pvalid, gt, gt_labels1, gt_valid, ranks, h: dict):
    """Fixed-size second-stage sample: -> rois, labels, matched, pos, valid."""
    props = torch.cat([gt, props], 1)
    pvalid = torch.cat([gt_valid, pvalid], 1)
    max_iou, matched = max_iou_rows(props.float(), gt.float(), gt_valid)
    is_fg = pvalid & (max_iou >= h["pos_iou_thr"])
    is_bg = pvalid & (max_iou < h["neg_iou_thr_hi"]) & (max_iou >= h["neg_iou_thr_lo"])
    ns = h["num_samples"]
    nfg = is_fg.sum(-1, keepdim=True).clamp(max=int(round(ns * h["pos_fraction"])))
    nbg = torch.minimum(is_bg.sum(-1, keepdim=True), ns - nfg)
    fg_pri = torch.where(is_fg, ranks[0], -1.0)
    cfg_ = is_fg & (stable_rank(-fg_pri) < nfg)
    bg_pri = torch.where(is_bg, ranks[1], -1.0)
    cbg = is_bg & (stable_rank(-bg_pri) < nbg)
    score = torch.where(cfg_, 2.0, torch.where(cbg, 1.0, 0.0))
    _, idx = sort_desc(score + fg_pri * 1e-4)
    idx = idx[:, :ns]
    rois = torch.gather(props, 1, idx[..., None].expand(*idx.shape, 4))
    sfg, sbg = torch.gather(cfg_, 1, idx), torch.gather(cbg, 1, idx)
    sm = torch.gather(matched, 1, idx)
    lab = torch.where(sfg, torch.gather(gt_labels1, 1, sm), 0)
    lab = torch.where(sfg | sbg, lab, -1).to(torch.int32)
    return rois, lab, sm, sfg, sfg | sbg


def smooth_l1(pred, target, beta):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def warmup_multistep(o: dict, steps_per_epoch: int):
    """The learning rate by step, in float32 as the program's schedule:
    linear warm-up from ``warmup_ratio``, then a decay by epochs."""
    f32 = np.float32
    decay = tuple(int(e * steps_per_epoch) for e in o["lr_decay_epochs"])

    def lr(step) -> float:
        step = f32(step)
        frac = np.clip(step / f32(max(o["warmup_steps"], 1)), f32(0.0), f32(1.0))
        w = f32(o["base_lr"]) * (f32(o["warmup_ratio"]) + f32(1.0 - o["warmup_ratio"]) * frac)
        return float(w * f32(o["lr_decay_factor"]) ** f32(sum(step >= s for s in decay)))

    return lr


def sgd_step(params: dict, grads: dict, trace: dict, lr: float, o: dict) -> dict:
    """Clip by global norm, add decayed weights, momentum SGD, in place on
    ``params`` and ``trace``; -> the clipped gradients."""
    names = list(params)
    g = {n: grads.get(n, torch.zeros_like(params[n])) for n in names}
    norm = torch.stack([g[n].double().square().sum() for n in names]).sum().sqrt().float()
    if o["grad_clip"] and norm >= o["grad_clip"]:
        g = {n: g[n] / norm * o["grad_clip"] for n in names}
    for n in names:
        u = g[n] + o["weight_decay"] * params[n]
        trace[n] = u + o["momentum"] * trace[n]
        params[n] = params[n] - lr * trace[n]
    return g
