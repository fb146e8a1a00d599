"""The R-CNN family: Faster R-CNN and Cascade R-CNN (box heads) over a
ResNet-FPN, as the port's ``models/detectors/rcnn.py`` runs them. The module
binds the family's f32 reference (``benchmark/reference/``) to the harness:
it holds everything of a run that depends on the detector, under the names
``benchmark/spec.py::FAMILY`` lists. A configuration file names it by its
top-level ``"family": "rcnn"``.

Inference is judged (``judge_infer``) for each sampled image of a sampled
batch:
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

Training is judged by ``benchmark/check.py`` over ``train_step``, the
reference's R-CNN losses (``reference/train.py``), which follows the
program's proposals (made from its RPN outputs) and cascade rois (refined
with its detached deltas): ``Follow`` keeps both of each followed step.
"""

from __future__ import annotations

import torch

from benchmark import flops
from benchmark.reference import detector as D
from benchmark.reference import infer as RI
from benchmark.reference import train as RT

BOX_TOL_PX = 1e-3   # a detection's box against its candidate's (the same decode in f32)
SCORE_TOL = 1e-6    # a detection's score against its candidate's (the same probability)
SHIFT_ULP_PX = 8e-3  # class-aware NMS shifts each class's boxes by up to ~1e5 px, where an
                     # f32 coordinate rounds by up to this much

# ---------------------------------------------------------------- weights

param_specs = D.param_specs


def weight_laws(m: dict) -> dict:
    """{init kind of ``param_specs``: (law, argument)} for
    ``benchmark/weights.py::make_weights``: he normal convs, xavier FPN and
    fc layers, normal RPN and predictors with the recipe's ``rpn_std``,
    ``cls_std`` and ``bbox_std``, FrozenBN at identity but each residual
    block's last gamma 1/sqrt(blocks). A kind not listed (biases, betas,
    means, the offset convs until calibrated) is zero."""
    return {"conv": ("he_normal", None), "fpn": ("xavier_uniform", None),
            "fc": ("xavier_uniform", None), "rpn": ("normal", "rpn_std"),
            "cls": ("normal", "cls_std"), "bbox": ("normal", "bbox_std"),
            "bn_gamma_last": ("constant", len(D.blocks(m)) ** -0.5),
            "bn_gamma": ("constant", 1.0), "bn_var": ("constant", 1.0)}


@torch.no_grad()
def calibration_forward(W: dict, m: dict, raw, hw, on_offset) -> None:
    """One f32 forward pass of the reference's backbone over the images
    ``raw`` (B, H, W, 3) of sizes ``hw``, transformed as at test time,
    calling ``on_offset(name, x)`` with each deformable layer's offset conv
    weight name and that layer's input."""
    n = raw.shape[0]
    with D.float32_exact():
        images, _, _ = D.transform(raw, hw, torch.zeros(n, dtype=torch.bool, device=raw.device),
                                   torch.zeros((n, 1, 4), device=raw.device), m, RI.canvas(m))
        D.backbone(images, W, m, D.F32,
                   on_dcn=lambda prefix, x: on_offset(f"{prefix}.conv2.offset_conv.weight", x))


# ---------------------------------------------------------------- the reference's precisions

F32 = D.F32       # the reference: float32, TF32 off
CONTROL = D.FP8   # the control: float8 e4m3 operands, one step below the configurations' bfloat16
warmup_multistep = D.warmup_multistep  # the learning rate by step (the program's schedule)
sgd_step = D.sgd_step                  # ClippedSGD: clip, decay, momentum, in place


# ---------------------------------------------------------------- training


class Follow:
    """Forward hooks on the program's RPN and box heads that keep, while
    ``recording()`` holds (a step the reference follows), the RPN outputs
    and each stage's box deltas; ``take()`` hands them over for one step."""

    def __init__(self, model, m: dict, batch: int, recording):
        self.b, self.n_st, self.cur = batch, D.num_stages(m), {}

        def keep_rpn(mod, inp, out):
            if recording():
                self.cur["rpn"] = tuple([x.detach() for x in o] for o in out)

        def keep_deltas(i):
            def hook(mod, inp, out):
                if recording():
                    self.cur.setdefault("deltas", {})[i] = out[1].detach()
            return hook

        self.hooks = [model.rpn.register_forward_hook(keep_rpn)]
        self.hooks += [model.bbox_head(i).register_forward_hook(keep_deltas(i))
                       for i in range(self.n_st)]

    def take(self) -> dict:
        """What the step just run chose, for ``train_step`` to follow: its
        RPN outputs (cls, reg by level) and the deltas of every stage but
        the last (B, R, 4)."""
        f = {"rpn": self.cur["rpn"],
             "deltas": [self.cur["deltas"][i].reshape(self.b, -1, 4) for i in range(self.n_st - 1)]}
        self.cur.clear()
        return f

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


def whole_batch(step: dict, b: int) -> bool:
    """Whether a followed step ran on the whole batch of ``b`` images."""
    return all(x.shape[0] == b for x in [*step["rpn"][0], *step["rpn"][1], *step["deltas"]])


def train_step(params: dict, buffers: dict, m: dict, batch: dict, followed: dict, prec,
               images=None) -> tuple:
    """The reference's step in ``prec`` over ``images`` (the whole batch by
    default), following the draws and choices of ``followed`` -> (loss,
    {name: gradient})."""
    with D.float32_exact():
        return RT.step(params, buffers, m, batch, followed["draws"], followed["rpn"],
                       followed["deltas"], prec, images)


# ---------------------------------------------------------------- inference

DETECTIONS = ("boxes", "scores", "labels", "valid")  # what the entry returns an image


class Keep:
    """Forward hooks on the program's RPN and cascade heads; ``take(out,
    b)`` returns what the reference follows of the batch the entry just
    ran (``out`` the entry's outputs): the RPN outputs, every stage's
    deltas but the last, the rois, their valid mask, probs and deltas."""

    def __init__(self, model):
        self.slot, self.stages = [None], {}
        self.hooks = [model.rpn.register_forward_hook(lambda mod, inp, out: self.slot.__setitem__(0, out))]
        for j in range(model.num_stages - 1):
            self.hooks.append(model.bbox_head(j).register_forward_hook(
                lambda mod, inp, out, j=j: self.stages.__setitem__(j, out[1])))

    def take(self, out: dict, b: int) -> dict:
        stages = [self.stages[j].reshape(b, -1, 4) for j in sorted(self.stages)]
        kept = {"rpn": out.get("rpn", self.slot[0]), "stage_deltas": out.get("stage_deltas", stages),
                **{key: out[key] for key in ("rois", "roi_valid", "probs", "deltas")}}
        self.stages.clear()
        self.slot[0] = None
        return kept

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


@torch.no_grad()
def detect(W: dict, m: dict, raw, hw, prec) -> tuple:
    """The reference in the program's place (the control): the batch as
    the entry computes it, in ``prec`` -> (detections, outputs with what
    ``Keep.take`` reads)."""
    with D.float32_exact():
        dets, out, rpn = RI.detect(W, m, raw, hw, prec)
    out["rpn"] = rpn
    return dets, out


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
@D.float32_exact()
def judge_infer(W: dict, m: dict, samples: list) -> dict:
    """``samples``: [{raw, hw (on the device), images (indices to check),
    dets (host: ``DETECTIONS``), and what ``Keep.take`` kept: rpn (cls, reg
    by level), stage_deltas (each cascade stage's but the last), rois,
    roi_valid, probs, deltas}] -> the four gaps of the module's docstring
    and the counts behind them (``images_checked``, ``detections_checked``,
    ``not_reproduced`` and ``not_reproduced_why``)."""
    rpn_gap = score_gap = box_gap = stage_gap = 0.0
    n_img = n_det = n_bad = 0
    reasons = []
    k = m["bbox_head"]["num_classes"]
    for s in samples:
        b = s["raw"].shape[0]
        sel = list(s["images"])
        rpn_cls, rpn_reg = s["rpn"]
        shapes_ok = (all(t.shape[0] == b for t in [*rpn_cls, *rpn_reg, *s["stage_deltas"],
                                                    s["rois"], s["roi_valid"], s["probs"],
                                                    s["deltas"]])
                     and all(v.shape[0] == b for v in s["dets"].values()))
        if not shapes_ok:
            rpn_gap, score_gap, box_gap, stage_gap = max(rpn_gap, 1.0), 1.0, 1.0, 1.0
            n_bad += 1
            continue
        dev = s["raw"].device
        res = RI.judge_images(W, m, s["raw"][sel], s["hw"][sel],
                              [c[sel] for c in rpn_cls], [r[sel] for r in rpn_reg],
                              [d[sel] for d in s["stage_deltas"]])
        for n, j in enumerate(sel):
            n_img += 1
            rpn_gap = max(rpn_gap, _rel_gap([c[j] for c in rpn_cls], res["rpn_cls"][n]),
                          _rel_gap([r[j] for r in rpn_reg], res["rpn_reg"][n]))
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


# ---------------------------------------------------------------- the traced slices


def infer_marks(model, marks) -> list:
    """Hooks that end the spans ``transform``, ``backbone``, ``rpn`` and
    ``roi_heads`` of ``marks`` (``cell.Marks``) at the program's module
    boundaries -> the hooks."""
    n = model.num_stages
    return [model.backbone.register_forward_pre_hook(lambda *_: marks.mark("transform")),
            model.backbone.register_forward_hook(lambda *_: marks.mark("backbone")),
            model.bbox_head(0).register_forward_pre_hook(lambda *_: marks.mark("rpn")),
            model.bbox_head(n - 1).register_forward_hook(lambda *_: marks.mark("roi_heads"))]


def infer_facts(out: dict) -> dict:
    """What ``infer_bounds`` reads of one traced batch's outputs."""
    return {"rois": out["rois"], "roi_valid": out["roi_valid"]}


def infer_bounds(m: dict, facts: list, b: int) -> dict:
    """Least seconds of K1 and of K5/K5b over the traced batches, counted
    from their own rois and the configuration's shapes. A cascade's first
    two stages are counted on the last stage's rois (the program returns
    those alone)."""
    canvas = RI.canvas(m)
    levels = [(-(-canvas[0] // 2 ** lv), -(-canvas[1] // 2 ** lv)) for lv in range(2, 6)]
    p, c, n = m["roi"]["output_size"], m["fpn"]["out_channels"], D.num_stages(m)
    k1 = 0.0
    for f in facts:
        rois, valid = f["rois"].float(), f["roi_valid"]
        touched = flops.touched_pixels(rois, valid, levels, m)
        k1 += n * flops.roi_align_fwd_bound(rois.shape[0] * rois.shape[1], int(valid.sum()),
                                            touched, p, c)
    k5 = len(facts) * sum(flops.dcn_bound(b, h, w, ch, s) for h, w, ch, s in flops.dcn_layers(m, canvas))
    return {"roi_align_fwd": k1, "dcn_fwd": k5, "items": len(facts)}


def train_facts(model, facts: list) -> list:
    """Hooks that append (offsets (B, Ho, Wo, 18) f32, H, W, C, stride) of
    every deformable layer to ``facts`` -> the hooks."""
    def capture(mod, inp, out):
        facts.append((out.detach().permute(0, 2, 3, 1).float(), inp[0].shape[2],
                      inp[0].shape[3], inp[0].shape[1], mod.stride[0]))

    return [mm.offset_conv.register_forward_hook(capture) for mm in model.modules()
            if type(mm).__name__ == "DeformConv"]


def train_bounds(m: dict, facts: list, b: int, steps: int) -> dict:
    """Least seconds of K3 and of K6/K6b + K7/K7b over the traced steps: K3
    from the sampled rois (every roi of every stage) and the pyramid's
    shape, the DCN backward from the offsets of the slice's first step."""
    canvas = RI.canvas(m)
    pixels = sum(-(-canvas[0] // 2 ** lv) * -(-canvas[1] // 2 ** lv) for lv in range(2, 6))
    p, c = m["roi"]["output_size"], m["fpn"]["out_channels"]
    n_rois = b * m["bbox_head"]["num_samples"]
    k3 = steps * D.num_stages(m) * flops.roi_align_bwd_bound(n_rois, b * pixels, p, c)
    dcn = steps * sum(flops.dcn_bwd_bound(off, h, w, ch, s) for off, h, w, ch, s in facts)
    return {"roi_align_bwd": k3, "dcn_bwd": dcn, "items": steps}


# ---------------------------------------------------------------- model FLOPs


def model_flops(m: dict, canvas: tuple, rois_per_image: int) -> float:
    """Model FLOPs (a multiply-add counted as 2) of one image's forward pass
    at ``canvas`` (H, W): every conv of the backbone (``flops.resnet_flops``),
    the FPN, the RPN head on P2-P6, and each R-CNN stage's two fc layers and
    predictors over ``rois_per_image`` rois. Elementwise work, RoIAlign, NMS
    and the deformable sampling are not counted."""
    H, W = canvas
    f, sizes = flops.resnet_flops(m, canvas)
    c = m["fpn"]["out_channels"]
    for lv in range(2, 6):
        fh, fw = sizes[lv - 2]
        f += flops.conv_flops(flops.FPN_IN[lv - 2], c, 1, fh, fw) + flops.conv_flops(c, c, 3, fh, fw)
    a = len(m["rpn"]["anchor"]["scales"]) * len(m["rpn"]["anchor"]["ratios"])
    for s in m["rpn"]["anchor"]["strides"]:
        fh, fw = -(-H // s), -(-W // s)
        f += flops.conv_flops(c, c, 3, fh, fw) + flops.conv_flops(c, 5 * a, 1, fh, fw)
    p, fc, k = m["roi"]["output_size"], m["bbox_head"]["fc_channels"], m["bbox_head"]["num_classes"]
    agnostic = bool(m.get("cascade")) or m["bbox_head"]["class_agnostic"]
    nb = 4 if agnostic else 4 * (k + 1)
    stages = m["cascade"]["num_stages"] if m.get("cascade") else 1
    f += stages * rois_per_image * 2.0 * (p * p * c * fc + fc * fc + fc * (k + 1 + nb))
    return f


def flops_per_item(m: dict, b: int, train: bool) -> float:
    """Model FLOPs of a batch of ``b`` images at the configuration's canvas:
    the forward pass over the test proposals, or a training step (3x the
    forward pass over the sampled rois)."""
    if train:
        return 3 * b * model_flops(m, RI.canvas(m), m["bbox_head"]["num_samples"])
    return b * model_flops(m, RI.canvas(m), m["rpn"]["post_nms_top_n_test"])
