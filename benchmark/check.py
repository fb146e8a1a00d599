"""What decides ``correct``: the f32 reference judges what the timed path
produced.

Inference (``judge_infer``), for each sampled image of a sampled batch:
- ``rpn_gap``: the program's RPN outputs (every anchor's objectness and
  deltas) against the reference's own, the largest difference over the
  largest reference value, objectness and deltas apart, the larger kept;
- the reference makes proposals from the program's RPN outputs (following
  the program's own choice among near-tied scores) and runs its own second
  stage over them; ``greedy_sources`` finds, on the program's own rois,
  scores and deltas, which (roi, class) candidate each of the program's
  detections is, and holds the detections to what greedy NMS guarantees;
- ``det_score_gap``: each detection's score against the reference's score
  of that candidate, the largest absolute difference;
- ``det_box_gap``: each detection's box against the reference's decoded
  box of that candidate, the largest coordinate difference over the
  reference box's width (x) or height (y).
A cascade stage's rois are decoded from the program's deltas of the stage
before (an FPN level is a floor of a roi's size: rois a rounding apart
would read different maps); those deltas are judged on their own:
- ``stage_box_gap``: each valid roi of each cascade stage but the last,
  decoded with the program's deltas against the same roi decoded with the
  reference's own deltas of that stage, the largest coordinate difference
  over the reference box's width (x) or height (y).
An image whose detections fail ``greedy_sources`` (a box, label or score
that is no candidate's; a candidate twice; an overlap or an omission that
greedy NMS rules out), whose program rois or valid mask differ from those
the followed steps give, or a batch of the wrong size, reads 1 in both
detection gaps.

Training (``judge_train``): the reference follows two runs of three steps
from the same weights, optimizer state, batches and random draws
(``reference/train.py``): the set-up's first three steps, from the seeded
weights and zero momentum, and three steps of the measured window from a
step the seed picks, from the program's parameters and momentum cloned on
the device just before it. For each following:
- ``loss_gap``: each step's loss against the reference's, relative;
- ``grad_gap``: the first step's clipped gradient as the optimizer got it
  (its momentum buffer after the step less the decayed weights and the
  decayed momentum before it), leaf by leaf: the gap between the two norms
  over the reference leaf's norm or the median leaf's, whichever is
  larger, the worst leaf;
- ``update_gap``: the parameters' change over the three steps, the same way.
Leaves whose reference gradient is under a thousandth of the median leaf's
(the frozen stages, which only decay) are left out of both leaf numbers.
Each number is the larger of the two followings' (``merge_followings``).
"""

from __future__ import annotations

import math
import statistics

import torch

from .reference import detector as D
from .reference import infer as RI
from .reference import train as RT

BOX_TOL_PX = 1e-3   # a detection's box against its candidate's (the same decode in f32)
SCORE_TOL = 1e-6    # a detection's score against its candidate's (the same probability)
SHIFT_ULP_PX = 8e-3  # class-aware NMS shifts each class's boxes by up to ~1e5 px, where an
                     # f32 coordinate rounds by up to this much


def _rel_gap(prog: list, ref: list) -> float:
    num = max(float((p.float() - r.float()).abs().max()) for p, r in zip(prog, ref))
    den = max(float(r.abs().max()) for r in ref)
    return num / max(den, 1e-30)


def _box_gap(pb, rb) -> float:
    """The largest coordinate difference of boxes ``pb`` from ``rb`` over
    ``rb``'s width (x) or height (y), at least a pixel."""
    if rb.numel() == 0:
        return 0.0
    wh = torch.stack([rb[:, 2] - rb[:, 0], rb[:, 3] - rb[:, 1]], -1).clamp(min=1.0)
    return float(((pb - rb).abs() / wh.repeat(1, 2)).max())


def iou_tol(a, b):
    """How far the IoU of each pair of boxes ``a`` (N, 4), ``b`` (M, 4) can
    move when every coordinate moves by ``SHIFT_ULP_PX``: 8 such moves over
    the smallest side of the two, at least a pixel."""
    def side(x):
        return torch.minimum(x[:, 2] - x[:, 0], x[:, 3] - x[:, 1])
    return 1e-4 + 8 * SHIFT_ULP_PX / torch.minimum(side(a)[:, None], side(b)[None, :]).clamp(min=1.0)


@torch.no_grad()
def greedy_sources(rois, valid, probs, deltas, info, got: dict, m: dict) -> tuple:
    """Whether one image's detections ``got`` (boxes in the original image,
    scores, labels, valid) are what the postprocess makes of the program's
    own rois, probs and deltas: decode, the top ``pre_nms_per_class``
    candidates, class-aware greedy NMS, the top ``max_per_image`` over
    ``score_thr``. Not by replaying it, since a pair at the NMS threshold or
    a score at a cut decides by its last bit, but by what greedy NMS
    guarantees, each decision within ``iou_tol`` and ``SCORE_TOL``:
    every detection is a candidate (its label, its decoded box within
    ``BOX_TOL_PX``, its score) of the pool and over the threshold, none
    twice, in order of score; no two of one class overlap above the NMS
    threshold; every pool candidate over the threshold that is left out
    overlaps a detection of its class that scores as high at the threshold,
    or scores no higher than the last of ``max_per_image`` detections.
    -> (each detection's candidate index, None), or (None, what failed)."""
    t = m["test"]
    k_cls = m["bbox_head"]["num_classes"]
    cb, cs, cl = D.candidates(rois, probs, deltas, info, m)
    r = rois.shape[1]
    cb, cl = cb[0], cl.long()
    cs = torch.where(valid[0][:, None].expand(r, k_cls).reshape(-1), cs[0], torch.zeros_like(cs[0]))
    top, order = D.sort_desc(cs)
    k = min(t["pre_nms_per_class"], cs.shape[0])
    cut = float(top[k - 1])
    maybe = cs >= cut - SCORE_TOL        # in the pool, or tied with its last
    sure = cs > cut + SCORE_TOL
    orig = D.clip_boxes(cb / info[0, 2], info[0, :2])
    v = got["valid"].bool()
    pb, ps, pl = got["boxes"][v].float(), got["scores"][v].float(), got["labels"][v].long()
    n = pb.shape[0]
    if n == 0:
        src = torch.zeros(0, dtype=torch.long, device=cb.device)
    else:
        hit = ((cl[None, :] == pl[:, None]) & maybe[None, :]
               & ((cs[None, :] - ps[:, None]).abs() <= SCORE_TOL)
               & ((orig[None, :, :] - pb[:, None, :]).abs().amax(-1) <= BOX_TOL_PX))
        if not bool(hit.any(-1).all()):
            return None, f"{int((~hit.any(-1)).sum())} detection(s) match no candidate"
        src = hit.float().argmax(-1)
        if src.unique().numel() != n:
            return None, "a candidate detected twice"
        if bool((ps <= t["score_thr"] - SCORE_TOL).any()):
            return None, "a detection under the score threshold"
        if n > t["max_per_image"] or bool((ps[1:] > ps[:-1] + SCORE_TOL).any()):
            return None, "detections out of order or too many"
    same = cl[src][:, None] == cl[None, :]
    kept = D.pairwise_iou(cb[src], cb[src])
    if n and bool(((kept > t["nms_thr"] + iou_tol(cb[src], cb[src])) & same[:, src]
                   & ~torch.eye(n, dtype=torch.bool, device=cb.device)).any()):
        return None, "two detections of one class overlap above the NMS threshold"
    left = sure & (cs > t["score_thr"] + SCORE_TOL)
    left[src] = False
    if bool(left.any()):
        c = left.nonzero()[:, 0]
        iou = D.pairwise_iou(cb[src], cb[c]) + iou_tol(cb[src], cb[c])
        covered = ((iou >= t["nms_thr"]) & same[:, c]
                   & (ps[:, None] >= cs[c][None, :] - SCORE_TOL)).any(0)
        if n == t["max_per_image"]:
            covered |= cs[c] <= ps[-1] + SCORE_TOL
        if not bool(covered.all()):
            return None, f"{int((~covered).sum())} candidate(s) over the threshold left out unsuppressed"
    return src, None


@torch.no_grad()
def judge_infer(W: dict, m: dict, samples: list) -> dict:
    """``samples``: [{raw, hw, rpn_cls, rpn_reg (per level), stage_deltas
    (each cascade stage's but the last), rois, roi_valid, probs, deltas
    (the program's outputs), dets (host: boxes, scores, labels, valid),
    images (indices to check)}] -> the four gaps and the counts behind
    them."""
    rpn_gap = score_gap = box_gap = stage_gap = 0.0
    n_img = n_det = n_bad = 0
    reasons = []
    k = m["bbox_head"]["num_classes"]
    for s in samples:
        b = s["raw"].shape[0]
        sel = list(s["images"])
        shapes_ok = (all(t.shape[0] == b for t in [*s["rpn_cls"], *s["rpn_reg"], *s["stage_deltas"],
                                                    s["rois"], s["roi_valid"], s["probs"],
                                                    s["deltas"]])
                     and all(v.shape[0] == b for v in s["dets"].values()))
        if not shapes_ok:
            rpn_gap, score_gap, box_gap, stage_gap = max(rpn_gap, 1.0), 1.0, 1.0, 1.0
            n_bad += 1
            continue
        dev = s["raw"].device
        res = RI.judge_images(W, m, s["raw"][sel], s["hw"][sel],
                              [c[sel] for c in s["rpn_cls"]], [r[sel] for r in s["rpn_reg"]],
                              [d[sel] for d in s["stage_deltas"]])
        for n, j in enumerate(sel):
            n_img += 1
            rpn_gap = max(rpn_gap, _rel_gap([c[j] for c in s["rpn_cls"]], res["rpn_cls"][n]),
                          _rel_gap([r[j] for r in s["rpn_reg"]], res["rpn_reg"][n]))
            for pb, rb in zip(res["stage_prog"][n], res["stage_ref"][n]):
                stage_gap = max(stage_gap, _box_gap(pb[res["props_valid"][n]], rb[res["props_valid"][n]]))
            info = res["im_info"][n][None]
            rois_p, valid_p = s["rois"][j:j + 1].float(), s["roi_valid"][j:j + 1]
            got = {key: v[j].to(dev) for key, v in s["dets"].items()}
            v = got["valid"].bool()
            n_det += int(v.sum())
            # the program's rois are those the followed proposal and cascade steps give
            why = None
            if not (torch.equal(valid_p[0], res["props_valid"][n])
                    and bool((rois_p[0] - res["rois"][n]).abs().max() <= BOX_TOL_PX)):
                why = "rois differ from the followed proposals"
            else:
                src, why = greedy_sources(rois_p, valid_p, s["probs"][j:j + 1].float(),
                                          s["deltas"][j:j + 1].float(), info, got, m)
            if why is not None:
                score_gap, box_gap = 1.0, 1.0
                n_bad += 1
                reasons.append(f"batch {s['k']} image {j}: {why}")
                continue
            if src.numel() == 0:
                continue
            roi, cls = src // k, src % k
            ref_s = res["probs"][n][roi, cls + 1]
            score_gap = max(score_gap, float((got["scores"][v].float() - ref_s).abs().max()))
            cb, _, _ = D.candidates(res["rois"][n][None], res["probs"][n][None],
                                    res["deltas"][n][None], info, m)
            rb = D.clip_boxes(cb[0][src] / info[0, 2], info[0, :2])
            box_gap = max(box_gap, _box_gap(got["boxes"][v].float(), rb))
    return {"rpn_gap": rpn_gap, "det_score_gap": score_gap, "det_box_gap": box_gap,
            "stage_box_gap": stage_gap,
            "images_checked": n_img, "detections_checked": n_det, "not_reproduced": n_bad,
            "not_reproduced_why": reasons}


def leaf_gap(prog: dict, ref: dict, counted: list) -> tuple:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median counted leaf's norm) -> (gap, leaf)."""
    rn = {n: float(ref[n].double().norm()) for n in counted}
    med = statistics.median(rn.values())
    worst, name = 0.0, None
    for n in counted:
        g = abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med, 1e-30)
        if g > worst:
            worst, name = g, n
    return worst, name


def judge_train(m: dict, params0: dict, buffers: dict, steps: list, prec=D.F32,
                images=None, steps_per_epoch: int = 1000, trace0: dict | None = None,
                step0: int = 0) -> dict:
    """The reference's following of three steps: ``steps`` holds each
    step's {batch, draws, rpn (cls, reg), deltas}, ``params0`` the weights
    before the first by parameter name, ``trace0`` the momentum buffers then
    (zeros by default) and ``step0`` the number of steps taken before it
    (the learning rate's step). It computes in ``prec`` over ``images`` (a
    control or a fault puts it in the program's place that way; by default
    f32 over the whole batch) -> {losses, g1 (the first step's clipped
    gradient), params3 (the parameters after the steps)}."""
    o = m["train"]["optim"]
    lr = D.warmup_multistep(o, steps_per_epoch)
    params = {n: v.clone() for n, v in params0.items()}
    trace = ({n: torch.zeros_like(v) for n, v in params0.items()} if trace0 is None
             else {n: v.clone() for n, v in trace0.items()})
    losses, g1 = [], None
    with D.float32_exact():
        for i, st in enumerate(steps):
            loss, grads = RT.step(params, buffers, m, st["batch"], st["draws"], st["rpn"],
                                  st["deltas"], prec, images)
            clipped = D.sgd_step(params, grads, trace, lr(step0 + i), o)
            if i == 0:
                g1 = clipped
            losses.append(loss)
    return {"losses": losses, "g1": g1, "params3": params}


def compare_train(ref: dict, prog: dict, params0: dict) -> dict:
    """The numbers of the module's docstring for one following of three
    steps, from two runs of it (``ref`` the f32 reference's, ``prog`` the
    program's or a control's, each {losses, g1, params3}; a program's ``g1``
    is worked out from its momentum buffers by ``program_g1``)."""
    n_steps = min(len(ref["losses"]), len(prog["losses"]))
    loss_gap = max(abs(prog["losses"][i] - ref["losses"][i]) / max(abs(ref["losses"][i]), 1e-30)
                   for i in range(n_steps))
    if any(not math.isfinite(x) for x in prog["losses"]):
        loss_gap = math.inf
    norms = {n: float(g.double().norm()) for n, g in ref["g1"].items()}
    live = sorted(v for v in norms.values() if v > 0)
    med = statistics.median(live)
    counted = [n for n, v in norms.items() if v >= 1e-3 * med]
    grad_gap, grad_leaf = leaf_gap(prog["g1"], ref["g1"], counted)
    d_ref = {n: ref["params3"][n] - params0[n] for n in counted}
    d_prog = {n: prog["params3"][n] - params0[n] for n in counted}
    update_gap, update_leaf = leaf_gap(d_prog, d_ref, counted)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
            "worst_grad_leaf": grad_leaf, "worst_update_leaf": update_leaf,
            "leaves_counted": len(counted), "leaves": len(norms),
            "ref_losses": ref["losses"], "prog_losses": prog["losses"]}


def program_g1(trace1: dict, params0: dict, o: dict, trace0: dict | None = None) -> dict:
    """The first followed step's clipped gradient from the momentum buffers
    before (``trace0``, zeros by default) and after it: m1 = g + wd * p0 +
    momentum * m0."""
    wd, mu = o["weight_decay"], o["momentum"]
    return {n: trace1[n] - wd * params0[n] - (0.0 if trace0 is None else mu * trace0[n])
            for n in trace1}


GAPS = ("loss_gap", "grad_gap", "update_gap")


def judge_followings(m: dict, extra: dict, prec, images=None, steps_per_epoch: int = 1000) -> dict:
    """A control or a fault put in the program's place over a run's
    followings (``extra`` as ``cell.run_train`` fills it): the reference in
    ``prec`` over ``images`` from each following's start -> the merged
    numbers against the f32 reference's."""
    parts = {}
    for name, f in extra["followings"].items():
        got = judge_train(m, f["params0"], extra["buffers"], f["steps"], prec, images,
                          steps_per_epoch, trace0=f["trace0"], step0=f["step0"])
        parts[name] = compare_train(f["ref"], got, f["params0"])
    return merge_followings(parts)


def not_followed(losses: list) -> dict:
    """``compare_train``'s numbers for a following the reference could not
    follow (the program's steps did not run on the whole batch): 1 each."""
    return {**{k: 1.0 for k in GAPS}, "worst_grad_leaf": None, "worst_update_leaf": None,
            "leaves_counted": 0, "leaves": 0, "prog_losses": losses, "ref_losses": []}


def merge_followings(parts: dict) -> dict:
    """{following: ``compare_train``'s numbers} -> each gap the largest of
    the followings', with every following's own beside it (``grad_gap.window``)."""
    out = {k: max(p[k] for p in parts.values()) for k in GAPS}
    for name, p in parts.items():
        out.update({f"{k}.{name}": p[k] for k in GAPS})
        out.update({f"worst_grad_leaf.{name}": p["worst_grad_leaf"],
                    f"worst_update_leaf.{name}": p["worst_update_leaf"],
                    f"losses.{name}": p["prog_losses"], f"ref_losses.{name}": p["ref_losses"]})
    out.update(leaves_counted=max(p["leaves_counted"] for p in parts.values()),
               leaves=max(p["leaves"] for p in parts.values()))
    return out
