"""The reference's training step: the R-CNN losses, their gradients image by
image, and the clipped momentum SGD update, in float32.

The step follows the program's own discrete choices where those depend on
rounding: the proposals are made (by the reference) from the program's RPN
outputs of that step, and a cascade stage's rois are refined from the
program's detached deltas of the stage before. Everything that carries a
gradient, and every target, is the reference's own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import detector as D
from .infer import canvas, features


def targets(m: dict, batch: dict, draws: dict, prog_rpn: tuple, prog_deltas: list) -> dict:
    """Everything of a step that carries no gradient, for the whole batch:
    the transformed images, the RPN's sampled anchors and their targets,
    the proposals from the program's RPN outputs, and each stage's rois,
    labels, positives and regression targets."""
    out_hw = canvas(m, bool(batch["portrait"]))
    images, gt, info = D.transform(batch["raw"], batch["hw"], batch["flip"].bool(),
                                   batch["gt_boxes"], m, out_hw)
    gt_valid = (batch["gt_valid"].bool() & ((gt[..., 2] - gt[..., 0]) >= 1.0)
                & ((gt[..., 3] - gt[..., 1]) >= 1.0))
    labels1 = torch.where(gt_valid, batch["gt_labels"].long() + 1, 0)
    b = images.shape[0]
    lv_anchors = D.level_anchors(m, out_hw, images.device)
    anchors = torch.cat(lv_anchors, 0)
    n = anchors.shape[0]
    resized = info[:, :2] * info[:, 2:3]
    hw = resized[:, None, :]
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] <= hw[..., 1]) & (anchors[None, :, 3] <= hw[..., 0]))
    r = m["rpn"]
    matched, alabels = D.assign_anchors(anchors.expand(b, n, 4), gt, gt_valid, inside,
                                        r["pos_iou_thr"], r["neg_iou_thr"])
    smask, pos = D.subsample(alabels, r["batch_size"], r["pos_fraction"], draws["rpn"])
    mgt = torch.gather(gt, 1, matched[..., None].expand(b, n, 4))
    rpn_tgt = D.encode_boxes(anchors[None], mgt, r["bbox_stds"])
    props, pv = D.proposals(prog_rpn[0], prog_rpn[1], lv_anchors, resized,
                            r["pre_nms_top_n_train"], r["post_nms_top_n_train"], r["nms_thr"],
                            r["bbox_stds"])
    h = m["bbox_head"]
    rois, lab, sm, pos_r, valid = D.sample_rois(props, pv, gt, labels1, gt_valid,
                                                draws["sample_rois"], h)
    stages = []
    for i in range(D.num_stages(m)):
        mg = torch.gather(gt, 1, sm[..., None].expand(b, rois.shape[1], 4))
        stages.append({"rois": rois, "labels": lab, "pos": pos_r, "valid": valid,
                       "reg_tgt": D.encode_boxes(rois, mg, D.stage_stds(m, i))})
        if i + 1 < D.num_stages(m):
            rois = D.clip_boxes(D.decode_boxes(rois, prog_deltas[i].float(), D.stage_stds(m, i)),
                                resized[:, None, :])
            iou, sm = D.max_iou_rows(rois.float(), gt, gt_valid)
            pos_r = valid & (iou >= m["cascade"]["stage_iou_thrs"][i + 1])
            lab = torch.where(pos_r, torch.gather(labels1, 1, sm), 0)
            lab = torch.where(valid, lab, -1).to(torch.int32)
    return {"images": images, "info": info, "rpn_mask": smask, "rpn_pos": pos,
            "rpn_tgt": rpn_tgt, "stages": stages}


def image_loss(W, m: dict, t: dict, j: int, prec) -> torch.Tensor:
    """Image ``j``'s share of the step's loss before the mean over images."""
    pyr, cls, reg = features(W, m, t["images"][j:j + 1], prec)
    rc = torch.cat([c.reshape(-1) for c in cls])
    rr = torch.cat([x.reshape(-1, 4) for x in reg])
    mask, pos = t["rpn_mask"][j], t["rpn_pos"][j]
    nsamp = mask.sum().clamp(min=1).float()
    tgt = pos.float()
    bce = -(tgt * F.logsigmoid(rc) + (1 - tgt) * F.logsigmoid(-rc))
    total = (torch.where(mask, bce, 0.0).sum() / nsamp
             + torch.where(pos[:, None], D.smooth_l1(rr, t["rpn_tgt"][j], 1.0 / 9.0), 0.0).sum()
             / nsamp) * m["rpn"]["loss_weight"]
    k = m["bbox_head"]["num_classes"]
    for i, st in enumerate(t["stages"]):
        w = m["cascade"]["stage_loss_weights"][i] if m.get("cascade") else 1.0
        valid, lab = st["valid"][j:j + 1], st["labels"][j]
        f = D.roi_align(pyr, st["rois"][j:j + 1], valid, m, m["roi"]["output_size"])
        cl, dl = D.bbox_head(f[0], W, i, prec)
        safe = lab.long().clamp(0, k)
        nll = -torch.gather(F.log_softmax(cl, -1), -1, safe[:, None])[:, 0]
        nll = torch.where(valid[0], nll, 0.0)
        if dl.shape[-1] != 4:
            dl = torch.gather(dl.reshape(-1, k + 1, 4), 1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
        l1 = torch.where(st["pos"][j], D.smooth_l1(dl, st["reg_tgt"][j],
                                                   m["bbox_head"]["smooth_l1_beta"]).sum(-1), 0.0)
        norm = valid.sum().clamp(min=1).float()
        total = total + w * (nll.sum() / norm + l1.sum() / norm * m["bbox_head"]["loss_bbox_weight"])
    return total


def step(params: dict, buffers: dict, m: dict, batch: dict, draws: dict, prog_rpn: tuple,
         prog_deltas: list, prec, images=None) -> tuple:
    """One step's loss and gradients: -> (loss, {name: gradient}). The
    loss is the mean over ``images`` (every image of the batch by
    default) of each image's loss; the gradient is taken image by image
    and summed, so that the step fits beside the activations of one
    image."""
    with torch.no_grad():
        t = targets(m, batch, draws, prog_rpn, prog_deltas)
    images = list(range(batch["raw"].shape[0])) if images is None else list(images)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    W = {**buffers, **leaves}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = 0.0
    for j in images:
        lj = image_loss(W, m, t, j, prec) / len(images)
        names = [k for k, v in leaves.items()]
        gs = torch.autograd.grad(lj, [leaves[k] for k in names], allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] += g
        loss += float(lj.detach())
    return loss, grads
