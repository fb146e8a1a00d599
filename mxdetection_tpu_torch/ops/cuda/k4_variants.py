"""Time the RPN assigner's route on the card: where ``rcnn_loss`` spends its
time in a training step (``--split``), and the max-IoU assigner (K4,
``csrc/iou.cu``) at the RPN shape beside edited copies of it and, with
``--baseline DIR``, beside another checkout's route.

Run from the root of a checkout on a machine with a CUDA card::

    python -m mxdetection_tpu_torch.ops.cuda.k4_variants --split

``--split`` drives ``Trainer.run_step`` of Faster R-CNN R50-FPN and of
Cascade R-CNN R101-DCN at 8x832x1344 in bf16 (seeded weights, the batch of
``chip_smoke.py``'s training path) and splits ``rcnn_loss`` of the steps
that follow the warm-up by CUDA events recorded around its calls of the
assigner's pieces: the IoU kernel (where the route has one), the rest of
``assign_max_iou``, ``subsample_labels`` and the remainder of the loss. It
works on this tree and on an older one whose ``ops/matching.py`` still
calls ``pairwise_iou_batched``.

Without ``--split`` it times the assigner's route (``assign_max_iou``: pass
A and pass B) at the RPN shape on two gt sets: phase 4's of
``chip_smoke.py`` (``k4_rpn_case``: 90 valid gt an image) and a training
step's (``chip_smoke.train_batch``: 3 to 11 valid of 100). Each variant is
a copy of ``csrc/`` with one edit to ``iou.cu`` (block size, rows a
thread, the division of disjoint pairs kept, no warp cull), built into
``_build/k4_variants/<name>/`` and loaded in turn, held bit for bit against
the dense plain assigner and timed by CUDA events, two rounds.
``--baseline DIR`` builds the kernels of ``DIR`` (for example the parent
commit, unpacked by ``git archive``) and times its route: the IoU matrix
of its ``mxdet_pairwise_iou`` and the dense torch passes on it
(``assign_from_iou``), in turns with this tree's, with each route's peak
memory and whether the two agree bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from .variants import build_variants, copy_with_edits, time_ms, use_variant

SPLIT_REPS = 5
SOURCE = "iou.cu"
VARIANTS = {
    "base": [],
    "rows_1": [("constexpr int kRowsPerThread = 2;", "constexpr int kRowsPerThread = 1;")],
    "rows_4": [("constexpr int kRowsPerThread = 2;", "constexpr int kRowsPerThread = 4;")],
    "threads_256": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    "no_cull": [("  const bool cull = kMode != kLabelsForced || thr.min_pos >= 0.0f;",
                 "  const bool cull = false;")],
    "no_skip": [("  if (!(iw > 0.0f && ih > 0.0f)) return 0.0f;  // disjoint: exactly +0\n", "")],
}


class LossSplit:
    """While active, records CUDA events around the calls of ``rcnn_loss``'s
    pieces that the module ``matching`` reaches through its attributes, and
    sums each piece's device-timeline ms (idle time inside it included) over
    the calls made while ``on`` is set."""

    PIECES = ("pairwise_iou_batched", "assign_max_iou", "subsample_labels")

    def __init__(self):
        from .. import matching

        self.module, self.on, self.ms, self.orig, self.pending = matching, False, {}, {}, []

    def _wrap(self, name, fn):
        import torch

        def wrapped(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pending.append((name, start, end))
            return out
        return wrapped

    def __enter__(self):
        for name in self.PIECES:
            if hasattr(self.module, name):
                self.orig[name] = getattr(self.module, name)
                setattr(self.module, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.module, name, fn)

    def collect(self) -> None:
        import torch

        torch.cuda.synchronize()
        for name, start, end in self.pending:
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
        self.pending.clear()


def split_step(name: str, cfg_name: str, device: str) -> None:
    """Print the split of ``rcnn_loss`` in the training step of ``cfg_name``."""
    import time

    import torch

    import chip_smoke
    from ...config import load_config
    from ...models.detectors.rcnn import rcnn_loss
    from ...train.trainer import Trainer

    b = chip_smoke.MAIN_BATCH
    cfg = load_config(cfg_name, {"data.batch_size_per_device": b})
    trainer = Trainer(cfg, device=device, seed=0, steps_per_epoch=117266 // b)
    batch = chip_smoke.train_batch(b, (480, 640), torch.Generator().manual_seed(9), device)
    for _ in range(2):
        trainer.run_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(SPLIT_REPS):
        t0 = time.perf_counter()
        trainer.run_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total, split = 0.0, LossSplit()
    with split:
        for _ in range(SPLIT_REPS):
            tb = trainer.device_batch(batch)
            for p in trainer.params:
                p.grad = None
            out = trainer.model.forward_train(tb, trainer.draws)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            split.on = True
            start.record()
            loss, _ = rcnn_loss(out, tb, trainer.draws, trainer.cfg)
            end.record()
            split.on = False
            loss.backward()
            split.collect()
            total += start.elapsed_time(end)
            loss_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            del out, loss
    ms = {k: v / SPLIT_REPS for k, v in split.ms.items()}
    total /= SPLIT_REPS
    iou = ms.get("pairwise_iou_batched", 0.0)
    assign = ms["assign_max_iou"]
    sub = ms["subsample_labels"]
    step_ms = sorted(times)[len(times) // 2]
    print(f"{name} step: median {step_ms:.2f} ms of {SPLIT_REPS}, peak {step_peak:.2f} GiB; "
          f"rcnn_loss {total:.3f} ms, peak {loss_peak:.1f} MiB above its inputs: IoU kernel "
          f"{iou:.3f}, rest of assign_max_iou {assign - iou:.3f}, subsample_labels {sub:.3f}, "
          f"remainder of rcnn_loss {total - assign - sub:.3f} (CUDA events, mean of "
          f"{SPLIT_REPS})", flush=True)
    del trainer
    torch.cuda.empty_cache()


def make_variant(name: str, src_dir: str, root: str) -> str:
    """Copy ``src_dir`` (a csrc/) to ``root/csrc`` with variant ``name``'s
    edits applied to iou.cu; -> the copy's csrc directory."""
    return copy_with_edits(src_dir, root, SOURCE, VARIANTS[name])


def baseline_route(checkout: str):
    """Build ``checkout``'s kernels under ``_build/k4_variants/baseline/``;
    -> a function (boxes, gt, gt_valid, box_valid) -> ``AssignResult`` that
    runs the route of a checkout whose K4 wrote the IoU matrix: its
    ``mxdet_pairwise_iou``, then the dense torch passes."""
    import torch

    from . import build
    from .. import matching

    src_dir, build_dir = build.CSRC_DIR, build.BUILD_DIR
    try:
        build.CSRC_DIR = os.path.join(os.path.abspath(checkout), "mxdetection_tpu_torch", "csrc")
        build.BUILD_DIR = os.path.join(build_dir, "k4_variants", "baseline", "_build")
        path, secs, _ = build.build()
    finally:
        build.CSRC_DIR, build.BUILD_DIR = src_dir, build_dir
    print(f"built the baseline from {checkout} in {secs:.1f} s", flush=True)
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mxdet_pairwise_iou.argtypes = [p, ctypes.c_longlong, p, i, i, i, p, p]
    lib.mxdet_pairwise_iou.restype = i

    def route(boxes, gt, gt_valid, box_valid):
        b, n, g = boxes.shape[0], boxes.shape[1], gt.shape[1]
        iou = torch.empty((b, n, g), dtype=torch.float32, device=boxes.device)
        stride = 0 if boxes.stride(0) == 0 else n * 4
        build.check(lib.mxdet_pairwise_iou(boxes.data_ptr(), stride, gt.data_ptr(), b, n, g,
                                           iou.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream),
                    "baseline mxdet_pairwise_iou")
        iou.masked_fill_(~gt_valid[:, None, :], -1.0)
        return matching.assign_from_iou(iou, gt_valid, pos_iou_thr=0.7, neg_iou_thr=0.3,
                                        box_valid=box_valid)

    return route


def peak_mib(fn) -> float:
    """Device memory ``fn`` takes at its peak above what is allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def route_cases(device: str) -> list:
    """[(name, boxes, gt, gt_valid, box_valid)] at the RPN shape: phase 4's
    gt of ``chip_smoke.py`` and a training step's, scaled to the canvas."""
    import torch

    import chip_smoke

    boxes, gt, gt_valid, inside = chip_smoke.k4_rpn_case(device, torch.Generator().manual_seed(5))
    batch = chip_smoke.train_batch(boxes.shape[0], (480, 640), torch.Generator().manual_seed(9),
                                   device)
    return [("phase4", boxes, gt, gt_valid, inside),
            ("train_gt", boxes, batch["gt_boxes"] * (800.0 / 480.0), batch["gt_valid"], inside)]


def time_route(cases: list, base, libs: dict, card: str) -> None:
    """Print the baseline's route beside this tree's, then every variant's."""
    import torch

    from .. import matching

    kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3)
    refs = {name: matching.assign_max_iou_dense(bx, gt, gv, box_valid=bv, **kw)
            for name, bx, gt, gv, bv in cases}
    for name, bx, gt, gv, bv in cases:
        print(f"{name}: {int(gv.sum())} valid gt in {tuple(gv.shape)}, {bx.shape[1]} anchors an "
              f"image, {int((refs[name].labels == 1).sum())} positive", flush=True)
    if base:
        for name, bx, gt, gv, bv in cases:
            old = lambda: base(bx, gt, gv, bv)  # noqa: E731
            new = lambda: matching.assign_max_iou(bx, gt, gv, box_valid=bv, **kw)  # noqa: E731
            same = all(torch.equal(x, y) for x, y in zip(old(), new()))
            ms = [time_ms(old), time_ms(new), time_ms(new), time_ms(old)]
            print(f"card: {card}; {name}: baseline route {ms[0]:.4f} / {ms[3]:.4f} ms, peak "
                  f"{peak_mib(old):.1f} MiB; this tree {ms[1]:.4f} / {ms[2]:.4f} ms, peak "
                  f"{peak_mib(new):.1f} MiB (in turns); bit-identical: {same}", flush=True)
    print(f"card: {card}; ms per call of assign_max_iou on each gt set")
    for rnd in range(2):
        for vname, dirs in libs.items():
            use_variant(dirs)
            parts, ok = [], True
            for name, bx, gt, gv, bv in cases:
                got = matching.assign_max_iou(bx, gt, gv, box_valid=bv, **kw)
                ok &= all(torch.equal(x, y) for x, y in zip(got, refs[name]))
                ms = time_ms(lambda: matching.assign_max_iou(bx, gt, gv, box_valid=bv, **kw))
                parts.append(f"{name} {ms:.4f}")
            print(f"round {rnd} {vname:12s} {'bit-identical' if ok else 'DIFFERENT'} "
                  + ", ".join(parts), flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--split", action="store_true",
                        help="split rcnn_loss of the Faster and Cascade training steps")
    parser.add_argument("--baseline", help="a checkout whose IoU-matrix route to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the assigner's route runs only on the card")
    sys.path.insert(0, os.getcwd())  # chip_smoke.py, at the root of the checkout
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.split:
        split_step("faster", "faster_rcnn_r50_fpn_1x", "cuda")
        split_step("cascade", "cascade_rcnn_r101_dcn_1x", "cuda")
        return 0
    from . import build

    base = baseline_route(args.baseline) if args.baseline else None
    own = (build.CSRC_DIR, build.BUILD_DIR)
    libs = build_variants(VARIANTS, make_variant, "k4_variants")
    try:
        time_route(route_cases("cuda"), base, libs, torch.cuda.get_device_name(0))
    finally:
        use_variant(own)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
