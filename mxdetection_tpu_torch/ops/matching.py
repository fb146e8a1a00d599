"""IoU-based target assignment and fixed-shape random subsampling — port of
``mxdetection_tpu.ops.matching``, batched over images.

Every function takes a leading image dimension where the JAX functions are
``vmap``-ed per image. No caller needs the IoU matrix itself, only its
reductions: each box's max IoU over the valid gt and its first argmax, and
(for the low-quality force) each gt's best IoU over the boxes. On the card
K4 (``ops/cuda/iou.py``) reduces the matrix where it computes it, in the
schedule of the JAX package's chunked ``assign_max_iou`` (pass A reduces
the rows, pass B recomputes the IoUs for the force), and never writes it.
On the CPU the dense form ``assign_max_iou_dense`` takes the whole matrix;
it is also the kernels' plain version. The two agree bit for bit: the max
of floats is exact in any order, and the schedule changes no IoU.

Randomness. "Randomly keep k of the m eligible items" is "rank the items by
(eligible, random priority) and keep rank < k", as in JAX. The priorities
come from an injectable source ``draws(name, shape) -> tensor`` of uniform
[0, 1) numbers: by default ``TorchDraws``, a ``torch.Generator`` on the
model's device; in the tests, the JAX package's own ``jax.random`` draws,
made with the same key splits, so that the two packages pick the same
boxes. Each call asks for shape (2, B, n): per image, the draws of the two
sub-keys ``k1, k2 = split(key)`` of the JAX function. Ranks are taken with
stable sorts (``torch.argsort(stable=True)`` as ``jnp.argsort``) and the
final gather with ``topk_stable`` (ties to the lower index, as
``lax.top_k``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .boxes import pairwise_iou
from .nms import topk_stable

Draws = Callable[[str, tuple], torch.Tensor]


class TorchDraws:
    """The default source of draws: ``torch.rand`` from one generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, name: str, shape: tuple) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.generator.device)


class AssignResult(NamedTuple):
    """Per-box assignment, each (B, N)."""

    matched_gt: torch.Tensor   # index into the gt rows (valid where label != -2)
    labels: torch.Tensor       # int32: -2 ignore/pad, -1 ignore, 0 negative, 1 positive
    max_iou: torch.Tensor      # f32 max IoU with any valid gt (>= 0)


def masked_iou(boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """The IoU of boxes (B, n, 4) with gt (B, G, 4): (B, n, G), plain
    ``pairwise_iou`` with -1 at invalid gt."""
    return pairwise_iou(boxes, gt_boxes).masked_fill_(~gt_valid[:, None, :], -1.0)


def assign_from_iou(iou: torch.Tensor, gt_valid: torch.Tensor, *, pos_iou_thr: float,
                    neg_iou_thr: float, min_pos_iou: float = 0.0, match_low_quality: bool = True,
                    box_valid: torch.Tensor | None = None) -> AssignResult:
    """``assign_max_iou``'s rule on a whole masked IoU matrix (B, N, G), -1
    at invalid gt (``masked_iou``)."""
    max_iou, matched = iou.max(dim=-1)            # first index on ties, as jnp.argmax
    labels = torch.full(max_iou.shape, -1, dtype=torch.int32, device=iou.device)
    labels = torch.where(max_iou < neg_iou_thr, 0, labels).to(torch.int32)
    labels = torch.where(max_iou >= pos_iou_thr, 1, labels).to(torch.int32)

    if match_low_quality:
        gt_best = iou.amax(dim=1)                 # (B, G)
        is_best = ((iou >= (gt_best - 1e-7)[:, None, :]) & (iou > min_pos_iou)
                   & gt_valid[:, None, :])
        gt_ids = torch.arange(iou.shape[-1], dtype=torch.int32, device=iou.device)
        forced_gt = torch.where(is_best, gt_ids, -1).amax(dim=-1)
        force_pos = is_best.any(dim=-1)
        labels = torch.where(force_pos, 1, labels).to(torch.int32)
        matched = torch.where(force_pos, forced_gt.to(matched.dtype), matched)

    no_gt = ~gt_valid.any(dim=-1, keepdim=True)
    labels = torch.where(no_gt & (labels != -2), 0, labels).to(torch.int32)
    if box_valid is not None:
        labels = torch.where(box_valid, labels, -2).to(torch.int32)
    return AssignResult(matched, labels, max_iou.clamp(min=0.0))


def assign_max_iou_dense(boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                         **kw) -> AssignResult:
    """``assign_max_iou`` over the whole (B, N, G) IoU matrix: the CPU route
    and the plain version K4's two passes are held against, bit for bit.
    ``kw`` as ``assign_max_iou``'s."""
    return assign_from_iou(masked_iou(boxes, gt_boxes, gt_valid), gt_valid, **kw)


def assign_max_iou(boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor, *,
                   pos_iou_thr: float, neg_iou_thr: float, min_pos_iou: float = 0.0,
                   match_low_quality: bool = True,
                   box_valid: torch.Tensor | None = None) -> AssignResult:
    """Max-IoU assigner (RPN / R-CNN matching rule), batched over images.

    boxes (B, N, 4) f32 (an anchor set expanded over the batch is read in
    place), gt_boxes (B, G, 4) f32 padded, gt_valid (B, G), box_valid (B, N).
    Positive if max_iou >= pos_iou_thr, negative if < neg_iou_thr, ignore
    (-1) in between; with ``match_low_quality`` every box tying a valid
    gt's best IoU (above ``min_pos_iou``) is forced positive and matched to
    the last such gt. Images without gt get all boxes negative; boxes with
    ``box_valid`` False get -2. The gt's best IoU is taken over every box,
    ``box_valid`` or not. CPU tensors take ``assign_max_iou_dense``, CUDA
    tensors K4's two passes; any other device raises.
    """
    kw = dict(pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou,
              match_low_quality=match_low_quality, box_valid=box_valid)
    if boxes.device.type == "cpu":
        return assign_max_iou_dense(boxes, gt_boxes, gt_valid, **kw)
    if boxes.device.type == "cuda":
        from .cuda.iou import assign_max_iou_cuda

        return AssignResult(*assign_max_iou_cuda(boxes, gt_boxes, gt_valid, **kw))
    raise RuntimeError(f"assign_max_iou: no implementation for device {boxes.device}")


def max_iou_rows(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor) -> tuple:
    """Each box's max IoU over the valid gt (-1 where an image has none) and
    the first gt reaching it (int64): boxes (B, N, 4), gt (B, G, 4) f32 ->
    two (B, N). CPU tensors take the row max of ``masked_iou``, CUDA tensors
    one launch of K4's pass A; any other device raises."""
    if boxes.device.type == "cpu":
        return tuple(masked_iou(boxes, gt_boxes, gt_valid).max(dim=-1))
    if boxes.device.type == "cuda":
        from .cuda.iou import max_iou_rows_cuda

        return max_iou_rows_cuda(boxes, gt_boxes, gt_valid)
    raise RuntimeError(f"max_iou_rows: no implementation for device {boxes.device}")


def random_rank(draws: Draws, name: str, batch: int, n: int) -> torch.Tensor:
    """(2, B, n) random priorities in [0, 1): for each image, one row per
    sub-key (``k1``, ``k2``) of the JAX function."""
    u = draws(name, (2, batch, n))
    if tuple(u.shape) != (2, batch, n):
        raise ValueError(f"draws({name!r}) gave {tuple(u.shape)}, expected {(2, batch, n)}")
    return u


def _stable_rank(priority: torch.Tensor) -> torch.Tensor:
    """Rank of every element in a stable ascending sort along the last dim:
    ``jnp.argsort(jnp.argsort(x))``."""
    order = torch.argsort(priority, dim=-1, stable=True)
    pos = torch.arange(priority.shape[-1], device=priority.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def subsample_labels(labels: torch.Tensor, num_samples: int, pos_fraction: float,
                     ranks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Randomly keep at most ``num_samples`` boxes per image, at most
    ``pos_fraction`` of them positive. labels (B, N), ranks (2, B, N) ->
    (sample_mask (B, N), labels with the dropped boxes demoted to -1)."""
    is_pos = labels == 1
    is_neg = labels == 0
    max_pos = int(num_samples * pos_fraction)
    num_pos = is_pos.sum(dim=-1, keepdim=True).clamp(max=max_pos)
    pos_rank = _stable_rank(torch.where(is_pos, ranks[0], 2.0))
    keep_pos = is_pos & (pos_rank < num_pos)

    num_neg = torch.minimum(is_neg.sum(dim=-1, keepdim=True), num_samples - num_pos)
    neg_rank = _stable_rank(torch.where(is_neg, ranks[1], 2.0))
    keep_neg = is_neg & (neg_rank < num_neg)

    new_labels = torch.where(is_pos & ~keep_pos, -1, labels)
    new_labels = torch.where(is_neg & ~keep_neg, -1, new_labels).to(labels.dtype)
    return keep_pos | keep_neg, new_labels


class SampledRois(NamedTuple):
    """Fixed-size (B, S) sampled roi set for the second stage."""

    rois: torch.Tensor          # (B, S, 4): chosen fg first, then bg, then padding
    labels: torch.Tensor        # (B, S) int32 class labels; 0 background, -1 padding
    matched_gt: torch.Tensor    # (B, S) gt row of each roi
    pos_mask: torch.Tensor      # (B, S) bool
    valid_mask: torch.Tensor    # (B, S) bool: takes part in the cls loss


def sample_rois(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                ranks: torch.Tensor, *, num_samples: int, pos_fraction: float,
                pos_iou_thr: float, neg_iou_thr_hi: float, neg_iou_thr_lo: float = 0.0,
                add_gt_as_proposals: bool = True) -> SampledRois:
    """Fixed-shape proposal target, batched: proposals (B, P, 4) and
    proposal_valid (B, P); gt_boxes (B, G, 4), gt_labels (B, G) 1-based,
    gt_valid (B, G); ranks (2, B, G + P) (or (2, B, P) without the gt
    boxes). Returns exactly ``num_samples`` rois per image: random
    foregrounds (IoU >= pos_iou_thr, at most pos_fraction of the samples),
    then random backgrounds (neg_iou_thr_lo <= IoU < neg_iou_thr_hi), then
    invalid padding."""
    if add_gt_as_proposals:
        proposals = torch.cat([gt_boxes, proposals], dim=1)
        proposal_valid = torch.cat([gt_valid, proposal_valid], dim=1)

    max_iou, matched = max_iou_rows(proposals.float(), gt_boxes.float(), gt_valid)

    is_fg = proposal_valid & (max_iou >= pos_iou_thr)
    is_bg = proposal_valid & (max_iou < neg_iou_thr_hi) & (max_iou >= neg_iou_thr_lo)
    max_pos = int(round(num_samples * pos_fraction))
    num_fg = is_fg.sum(dim=-1, keepdim=True).clamp(max=max_pos)
    num_bg = torch.minimum(is_bg.sum(dim=-1, keepdim=True), num_samples - num_fg)

    # chosen fg get the top band, chosen bg the middle, the rest the bottom;
    # one stable top-k then yields [fg..., bg..., padding...]
    fg_pri = torch.where(is_fg, ranks[0], -1.0)
    chosen_fg = is_fg & (_stable_rank(-fg_pri) < num_fg)
    bg_pri = torch.where(is_bg, ranks[1], -1.0)
    chosen_bg = is_bg & (_stable_rank(-bg_pri) < num_bg)
    score = torch.where(chosen_fg, 2.0, torch.where(chosen_bg, 1.0, 0.0))
    _, idx = topk_stable(score + fg_pri * 1e-4, num_samples)

    rois = torch.gather(proposals, 1, idx[..., None].expand(*idx.shape, 4))
    sel_fg = torch.gather(chosen_fg, 1, idx)
    sel_bg = torch.gather(chosen_bg, 1, idx)
    sel_matched = torch.gather(matched, 1, idx)
    cls_labels = torch.where(sel_fg, torch.gather(gt_labels, 1, sel_matched), 0)
    cls_labels = torch.where(sel_fg | sel_bg, cls_labels, -1).to(torch.int32)
    return SampledRois(rois, cls_labels, sel_matched, sel_fg, sel_fg | sel_bg)
