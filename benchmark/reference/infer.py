"""The reference's inference batch: the whole program in plain torch
(``detect``), and its parts that judge a batch the program produced
(``judge_images``)."""

from __future__ import annotations

import torch

from . import detector as D


def canvas(m: dict, portrait: bool = False) -> tuple:
    d = m["data"]
    return (d["pad_w"], d["pad_h"]) if portrait and d["pad_h"] != d["pad_w"] else (d["pad_h"], d["pad_w"])


def features(W, m, images, prec):
    """images (B, H, W, 3) -> (FPN pyramid NCHW, RPN cls, RPN reg)."""
    pyr = D.fpn(D.backbone(images, W, m, prec), W, m, prec)
    cls, reg = D.rpn_head(pyr, W, prec)
    return pyr, cls, reg


def test_proposals(m, cls, reg, im_info, out_hw):
    r = m["rpn"]
    anchors = D.level_anchors(m, out_hw, im_info.device)
    resized = im_info[:, :2] * im_info[:, 2:3]
    return D.proposals(cls, reg, anchors, resized, r["pre_nms_top_n_test"],
                       r["post_nms_top_n_test"], r["nms_thr"], r["bbox_stds"])


@torch.no_grad()
def detect(W, m: dict, raw, hw, prec, chunk: int = 4) -> tuple:
    """The reference put in the program's place (the control): the batch as
    ``infer_batch`` computes it, in chunks of ``chunk`` images -> (dets,
    outputs with rois, roi_valid, probs, deltas, and the RPN outputs)."""
    out_hw = canvas(m)
    b = raw.shape[0]
    flip = torch.zeros(b, dtype=torch.bool, device=raw.device)
    parts = []
    for s in range(0, b, chunk):
        images, _, info = D.transform(raw[s:s + chunk], hw[s:s + chunk], flip[s:s + chunk],
                                      torch.zeros((min(chunk, b - s), 1, 4), device=raw.device),
                                      m, out_hw)
        pyr, cls, reg = features(W, m, images, prec)
        rois, valid = test_proposals(m, cls, reg, info, out_hw)
        resized = info[:, :2] * info[:, 2:3]
        last, probs, deltas, stages = D.second_stage(pyr, rois, valid, resized, W, m, prec)
        dets = D.postprocess(last, valid, probs, deltas, info, m)
        parts.append(({k: v for k, v in dets.items() if k != "source"},
                      {"rois": last, "roi_valid": valid, "probs": probs, "deltas": deltas,
                       "im_info": info, "stage_deltas": stages[:-1]}, (cls, reg)))
    cat = lambda ds: {k: (torch.cat([d[k] for d in ds]) if isinstance(ds[0][k], torch.Tensor) else  # noqa: E731
                          [torch.cat([d[k][i] for d in ds]) for i in range(len(ds[0][k]))])
                      for k in ds[0]}
    rpn = tuple([torch.cat([p[2][i][lv] for p in parts]) for lv in range(len(parts[0][2][i]))]
                for i in range(2))
    return cat([p[0] for p in parts]), cat([p[1] for p in parts]), rpn


@torch.no_grad()
def judge_images(W, m: dict, raw, hw, rpn_cls, rpn_reg, stage_deltas) -> dict:
    """What the f32 reference says of a batch's images, one at a time:
    its own RPN outputs beside the program's, the proposals it makes from
    the program's RPN outputs (the program's own proposal step, followed),
    and its own second stage over those proposals, a cascade stage's rois
    decoded from the program's deltas of the stage before (followed too),
    with each such stage's rois decoded both ways: with the program's deltas
    (``stage_prog``) and with the reference's own (``stage_ref``).
    Returns lists, one entry an image."""
    out_hw = canvas(m)
    res = {k: [] for k in ("rpn_cls", "rpn_reg", "props", "props_valid", "rois", "probs",
                           "deltas", "im_info", "stage_prog", "stage_ref")}
    for j in range(raw.shape[0]):
        images, _, info = D.transform(raw[j:j + 1], hw[j:j + 1],
                                      torch.zeros(1, dtype=torch.bool, device=raw.device),
                                      torch.zeros((1, 1, 4), device=raw.device), m, out_hw)
        pyr, cls, reg = features(W, m, images, D.F32)
        props, pv = test_proposals(m, [c[j:j + 1] for c in rpn_cls],
                                   [r[j:j + 1] for r in rpn_reg], info, out_hw)
        resized = info[:, :2] * info[:, 2:3]
        forced = [d[j:j + 1] for d in stage_deltas]
        rois, probs, deltas, own = D.second_stage(pyr, props, pv, resized, W, m, D.F32, forced=forced)
        stage_in, prog_b, ref_b = props, [], []
        for i, d in enumerate(forced):
            for out, x in ((prog_b, d.float()), (ref_b, own[i])):
                out.append(D.clip_boxes(D.decode_boxes(stage_in, x, D.stage_stds(m, i)),
                                        resized[:, None, :])[0])
            stage_in = prog_b[-1][None]
        res["stage_prog"].append(prog_b)
        res["stage_ref"].append(ref_b)
        for k, v in (("rpn_cls", cls), ("rpn_reg", reg)):
            res[k].append([t[0] for t in v])
        for k, v in (("props", props), ("props_valid", pv), ("rois", rois), ("probs", probs),
                     ("deltas", deltas), ("im_info", info)):
            res[k].append(v[0])
        del pyr
    return res
