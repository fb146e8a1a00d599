"""Time the greedy-NMS kernel (K2, ``csrc/nms.cu``) on the card: its two
launches apart (``--split``) with the rest of ``ops/nms.py::nms`` around
them, edited copies of it and, with ``--baseline DIR``, another checkout's
K2 in turns with this tree's.

Run from the root of a checkout on a machine with a CUDA card::

    python -m mxdetection_tpu_torch.ops.cuda.k2_variants [--split] [--baseline DIR] \
        [--boxes FILE] [--only base,no_skip]

The inputs are ``chip_smoke.py``'s phase 3 (``nms_cases``): the RPN's 40
problems x 1000 boxes at IoU 0.7, the class-aware test NMS's 8 x 1000 at
0.5 and the training RPN's 40 x 2000 at 0.7, score-sorted and clustered.

``--split`` builds two copies of this tree's ``csrc/`` (and of DIR's, with
``--baseline``) whose C entry point launches only the mask kernel
(``nms_mask_kernel``) or only the sweep (``nms_sweep_kernel``), and times
each beside the whole entry point by CUDA events; the sweep alone reads a
mask that a whole run wrote into the same scratch. It logs how many rows
each problem keeps, and times the rest of ``nms`` at each shape: the score
masking, the stable sort, the gathers, the scatter back and
``_select_top``.

``--boxes FILE`` adds the problems the main paths handed K2, saved by
``chip_smoke.py --k2-boxes FILE``, to every timing. Each case logs the
share of valid rows kept and of the mask kernel's tested pairs that do not
intersect.

Without ``--split`` each variant (or those ``--only`` names) is a copy of
``csrc/`` with one edit to ``nms.cu`` (the square tile-major layout, stages
in the ring, warps a block, no disjoint-pair skip, the first design's NaN
min/max, unrolled loops, the diagonal words loaded in the chain),
built into ``_build/k2_variants/<name>/`` and loaded in turn, held bit for
bit against the plain version (``nms_mask_sorted_plain``) and timed, two
rounds. ``--baseline DIR`` builds the kernels of ``DIR`` (for example the
parent commit, unpacked by ``git archive``) and times its K2 through its C
entry point in turns with this tree's (DIR, this, this, DIR), with whether
the two keep masks agree bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys

from .variants import build_variants, copy_with_edits, time_ms, use_variant

SOURCE = "nms.cu"
# the mask kernel's column loop fully unrolled for whole off-diagonal tiles
MASK_UNROLL = ("""    for (int j = start; j < cols; ++j) {
      if (iou_over(ab, area_a, &sbox[j * 4], sarea[j], thr)) bits |= 1ULL << j;
    }
""", """    if (start == 0 && cols == kTile) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (iou_over(ab, area_a, &sbox[j * 4], sarea[j], thr)) bits |= 1ULL << j;
      }
    } else {
      for (int j = start; j < cols; ++j) {
        if (iou_over(ab, area_a, &sbox[j * 4], sarea[j], thr)) bits |= 1ULL << j;
      }
    }
""")
# the owner warps' loop over word columns unrolled by 4
SWEEP_UNROLL = ("      for (int j = j0 + warp; j < ncols; j += kSweepWarps) {",
                "#pragma unroll 4\n      for (int j = j0 + warp; j < ncols; j += kSweepWarps) {")
# the first design of step 1: each diagonal word loaded where it is used,
# under the row's test, so every step of the chain waits on a load
RESOLVE_IN_LOOP = ("""      unsigned long long d[kTile];
#pragma unroll
      for (int b = 0; b < kTile; b += 2) {
        const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(st + b);
        d[b] = v.x;
        d[b + 1] = v.y;
      }
      unsigned long long rem = removed[t];
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        if (!((rem >> b) & 1ULL)) rem |= d[b];
      }
""", """      unsigned long long rem = removed[t];
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const unsigned long long d = st[b];
        if (!((rem >> b) & 1ULL)) rem |= d;
      }
""")
# the square tile-major layout: tile (t, w) at t*cb + w of a problem's cb*cb
# tiles, so a row tile's block is still one run; a mask block below the
# diagonal returns at once instead of inverting the packed index
SQUARE = [("  return (size_t)cb * (cb + 1) / 2;\n", "  return (size_t)cb * cb;\n"),
          ("  return (size_t)t * (2 * cb - t + 1) / 2;\n", "  return (size_t)t * (cb + 1);\n"),
          ("""  // row tile t: the largest t with tile_offset(t) <= k
  const double c2 = 2.0 * cb + 1.0;
  int t = (int)((c2 - sqrt(c2 * c2 - 8.0 * (double)k)) * 0.5);
  t = max(0, min(t, cb - 1));
  while (t > 0 && tile_offset(t, cb) > k) --t;
  while (t + 1 < cb && tile_offset(t + 1, cb) <= k) ++t;
  const int w = t + (int)(k - tile_offset(t, cb));
""", """  const int t = (int)(k / cb), w = (int)(k % cb);
  if (w < t) return;  // below the diagonal: never read
""")]
VARIANTS = {
    "base": [],
    "square": SQUARE,
    "stages_2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "stages_3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "warps_1": [("constexpr int kSweepWarps = 4;", "constexpr int kSweepWarps = 1;")],
    "warps_8": [("constexpr int kSweepWarps = 4;", "constexpr int kSweepWarps = 8;")],
    "no_skip": [("  if (!(iw > 0.0f && ih > 0.0f)) return 0.0f > thr;  // disjoint: IoU +0\n",
                 "")],
    # the first design's NaN-propagating min/max: two compares and a select
    "nan_select": [(f'  asm("{op}.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));\n  return r;',
                    f"  return (a != a || b != b) ? __int_as_float(0x7fc00000) : f{op}f(a, b);")
                   for op in ("max", "min")],
    "mask_unroll": [MASK_UNROLL],
    "sweep_unroll": [SWEEP_UNROLL],
    "resolve_in_loop": [RESOLVE_IN_LOOP],
}
MAX_OUT = {"rpn": 1000, "class_aware": 100, "rpn_train": 1000}  # post-NMS top-n, max_per_image


def drop_launch(text: str, kernel: str) -> tuple[str, str]:
    """The edit that removes the launch statement ``kernel<<<...>>>(...);``
    from ``text``, the source of an entry point."""
    found = re.findall(rf"[ \t]*{kernel}<<<.*?>>>\(.*?\);\n", text, flags=re.S)
    if len(found) != 1:
        raise ValueError(f"{SOURCE}: {len(found)} launches of {kernel}")
    return found[0], ""


def split_edits(csrc: str) -> dict:
    """{name: edits} of the split: the whole entry point, the mask kernel
    alone, the sweep alone."""
    with open(os.path.join(csrc, SOURCE)) as f:
        text = f.read()
    return {"whole": [], "mask_only": [drop_launch(text, "nms_sweep_kernel")],
            "sweep_only": [drop_launch(text, "nms_mask_kernel")]}


def build_copies(csrc: str, edits: dict, subdir: str) -> dict:
    """Build a copy of ``csrc`` for each of ``edits`` under
    ``_build/<subdir>/<name>/``; -> {name: (csrc dir, build dir)}."""
    from . import build

    own = build.CSRC_DIR
    build.CSRC_DIR = os.path.abspath(csrc)
    try:
        return build_variants(edits, lambda name, src, root: copy_with_edits(
            src, root, SOURCE, edits[name]), subdir)
    finally:
        build.CSRC_DIR = own


def runner(dirs: tuple):
    """Build the kernels of a (csrc dir, build dir) pair; -> a function
    (boxes, valid, thr, scratch, keep) that calls its
    ``mxdet_nms_mask_sorted`` on the current stream."""
    import torch

    from . import build

    own = (build.CSRC_DIR, build.BUILD_DIR)
    build.CSRC_DIR, build.BUILD_DIR = dirs
    try:
        path, _, _ = build.build()
    finally:
        build.CSRC_DIR, build.BUILD_DIR = own
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mxdet_nms_mask_sorted.argtypes = [p, p, i, i, ctypes.c_float, p, p, p]
    lib.mxdet_nms_mask_sorted.restype = i
    if hasattr(lib, "mxdet_nms_scratch_words"):
        lib.mxdet_nms_scratch_words.argtypes = [i, i]
        lib.mxdet_nms_scratch_words.restype = ctypes.c_longlong
        words = lib.mxdet_nms_scratch_words
    else:  # the first design: a row of ceil(N/64) words for each box
        words = lambda p_, n: p_ * n * -(-n // 64)

    def run(boxes, valid, thr, scratch, keep):
        p_, n = boxes.shape[:2]
        if scratch.numel() < words(p_, n):
            raise ValueError(f"{dirs[0]}: scratch of {scratch.numel()} words for {(p_, n)}")
        build.check(lib.mxdet_nms_mask_sorted(boxes.data_ptr(), valid.data_ptr(), p_, n, thr,
                                              scratch.data_ptr(), keep.data_ptr(),
                                              torch.cuda.current_stream().cuda_stream),
                    f"mxdet_nms_mask_sorted of {dirs[0]}")
        return keep

    run.words = words
    return run


def scratch_for(p: int, n: int, device, *runs):
    """Scratch large enough for the mask layout of each of ``runs``."""
    import torch

    return torch.zeros(max(r.words(p, n) for r in runs), dtype=torch.int64, device=device)


def kept_stats(keep) -> str:
    per = keep.sum(-1).float()
    return (f"kept a problem: min {int(per.min())}, median {int(per.median())}, "
            f"max {int(per.max())}, total {int(per.sum())}")


def rest_of_nms(name: str, boxes, valid, card: str) -> None:
    """Time the pieces of ``ops/nms.py::nms`` around the kernel on (P, N)
    problems with seeded scores (the sort then has work to do)."""
    import torch

    from .. import nms as nms_lib

    p, n = valid.shape
    scores = torch.rand((p, n), generator=torch.Generator().manual_seed(3)).to(boxes.device)
    max_out = MAX_OUT[name]
    valid_m, masked = nms_lib._mask_scores(scores, valid, -float("inf"))
    _, order = nms_lib._sort_desc(masked)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(p, n, 4))
    valid_s = torch.gather(valid_m, -1, order)
    keep_s = nms_lib.nms_mask_sorted(boxes_s, valid_s, 0.7)
    keep = torch.zeros_like(valid_s).scatter_(-1, order, keep_s)
    pieces = {
        "mask_scores": lambda: nms_lib._mask_scores(scores, valid, -float("inf")),
        "sort": lambda: nms_lib._sort_desc(masked),
        "gathers": lambda: (torch.gather(boxes, -2, order[..., None].expand(p, n, 4)),
                            torch.gather(valid_m, -1, order)),
        "kernel": lambda: nms_lib.nms_mask_sorted(boxes_s, valid_s, 0.7),
        "scatter": lambda: torch.zeros_like(valid_s).scatter_(-1, order, keep_s),
        "select_top": lambda: nms_lib._select_top(boxes, masked, keep, max_out),
        "nms": lambda: nms_lib.nms(boxes, scores, 0.7, max_out, valid=valid),
    }
    ms = {k: time_ms(fn) for k, fn in pieces.items()}
    print(f"card: {card}; {name} nms pieces, ms: " + ", ".join(f"{k} {v:.4f}"
                                                                for k, v in ms.items())
          + f"; pieces other than the kernel {sum(ms.values()) - ms['nms'] - ms['kernel']:.4f}",
          flush=True)


def split(label: str, csrc: str, cases: list, refs: dict, card: str) -> None:
    """Print the mask kernel's and the sweep's times apart, beside the whole
    entry point, for the kernels of ``csrc``."""
    import torch

    libs = build_copies(csrc, split_edits(csrc), f"k2_variants/split_{label}")
    run = {name: runner(dirs) for name, dirs in libs.items()}
    for name, thr, (boxes, valid) in cases:
        p, n = valid.shape
        scratch = scratch_for(p, n, boxes.device, run["whole"])
        keep = torch.empty((p, n), dtype=torch.bool, device=boxes.device)
        same = torch.equal(run["whole"](boxes, valid, thr, scratch, keep), refs[name])
        ms = {}
        for part in ("whole", "mask_only"):
            ms[part] = time_ms(lambda: run[part](boxes, valid, thr, scratch, keep))
        run["whole"](boxes, valid, thr, scratch, keep)  # the sweep reads this mask
        ms["sweep_only"] = time_ms(lambda: run["sweep_only"](boxes, valid, thr, scratch, keep))
        sweep_same = torch.equal(keep, refs[name])
        print(f"card: {card}; {label} K2 {name} {(p, n)}: whole {ms['whole']:.4f} ms, mask "
              f"kernel {ms['mask_only']:.4f}, sweep {ms['sweep_only']:.4f} (CUDA events); keep "
              f"bit-identical to the plain version: {same}, after the sweep alone: "
              f"{sweep_same}", flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--split", action="store_true",
                        help="time the mask kernel and the sweep apart, and the rest of nms")
    parser.add_argument("--baseline", help="a checkout whose K2 to time beside")
    parser.add_argument("--boxes", help="also time on the main-path problems that "
                                        "chip_smoke.py --k2-boxes FILE saved")
    parser.add_argument("--only", help="the variants to build and time, comma-separated")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K2 runs only on the card")
    sys.path.insert(0, os.getcwd())  # chip_smoke.py, at the root of the checkout
    import chip_smoke

    from . import build
    from ..nms import nms_mask_sorted_plain
    from .nms import nms_mask_sorted_cuda

    card = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    cases = chip_smoke.nms_cases("cuda")
    if args.boxes:
        cases += [(name, thr, (boxes.cuda(), valid.cuda()))
                  for name, (boxes, valid, thr) in torch.load(args.boxes).items()]
    refs = {name: nms_mask_sorted_plain(boxes, valid, thr) for name, thr, (boxes, valid) in cases}
    for name, thr, (boxes, valid) in cases:
        shares = chip_smoke.nms_shares(boxes, valid, refs[name])
        print(f"{name}: {tuple(valid.shape)} problems x N, IoU {thr}, {int(valid.sum())} valid "
              f"rows; {kept_stats(refs[name])}; kept share {shares['keep_share']:.4f}, "
              f"disjoint share of the {shares['tested_pairs']} tested pairs "
              f"{shares['disjoint_share']:.4f}", flush=True)
    base = os.path.join(os.path.abspath(args.baseline), "mxdetection_tpu_torch", "csrc") \
        if args.baseline else None
    if args.split:
        split("this_tree", build.CSRC_DIR, cases, refs, card)
        if base:
            split("baseline", base, cases, refs, card)
        for name, _, (boxes, valid) in cases:
            if name in MAX_OUT:
                rest_of_nms(name, boxes, valid, card)
        return 0
    if base:
        old = runner(build_copies(base, {"whole": []}, "k2_variants/baseline")["whole"])
        new = runner((build.CSRC_DIR, build.BUILD_DIR))
        for name, thr, (boxes, valid) in cases:
            p, n = valid.shape
            scratch = scratch_for(p, n, boxes.device, old, new)
            k_old = torch.empty((p, n), dtype=torch.bool, device=boxes.device)
            k_new = torch.empty_like(k_old)
            same = torch.equal(old(boxes, valid, thr, scratch, k_old),
                               new(boxes, valid, thr, scratch, k_new))
            ms = [time_ms(lambda: old(boxes, valid, thr, scratch, k_old)),
                  time_ms(lambda: new(boxes, valid, thr, scratch, k_new)),
                  time_ms(lambda: new(boxes, valid, thr, scratch, k_new)),
                  time_ms(lambda: old(boxes, valid, thr, scratch, k_old))]
            print(f"card: {card}; {name}: baseline {ms[0]:.4f} / {ms[3]:.4f} ms, this tree "
                  f"{ms[1]:.4f} / {ms[2]:.4f} ms (in turns); bit-identical: {same}", flush=True)
    own = (build.CSRC_DIR, build.BUILD_DIR)
    names = args.only.split(",") if args.only else list(VARIANTS)
    libs = build_copies(build.CSRC_DIR, {k: VARIANTS[k] for k in names}, "k2_variants")
    print(f"card: {card}; ms per call of nms_mask_sorted_cuda")
    try:
        for rnd in range(2):
            for vname, dirs in libs.items():
                use_variant(dirs)
                parts, ok = [], True
                for name, thr, (boxes, valid) in cases:
                    ok &= torch.equal(nms_mask_sorted_cuda(boxes, valid, thr), refs[name])
                    ms = time_ms(lambda: nms_mask_sorted_cuda(boxes, valid, thr))
                    parts.append(f"{name} {ms:.4f}")
                print(f"round {rnd} {vname:10s} {'bit-identical' if ok else 'DIFFERENT'} "
                      + ", ".join(parts), flush=True)
    finally:
        use_variant(own)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
