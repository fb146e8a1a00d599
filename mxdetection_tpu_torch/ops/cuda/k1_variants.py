"""Time the RoIAlign forward (K1, ``csrc/roi_align.cu``) on the card, beside
edited copies of it and, with ``--baseline DIR``, beside another checkout's
kernel.

Run from the root of a checkout on a machine with a CUDA card::

    python -m mxdetection_tpu_torch.ops.cuda.k1_variants [--rois FILE] [--baseline DIR]

The inputs are ``chip_smoke.py``'s phase 2 (8 x 1000 rois over P2-P5 of
832x1344, seed 1) with seeded bf16 features of 256 channels and, with
``--rois FILE`` (saved by ``chip_smoke.py --k3-rois FILE``), the rois of
one Faster R-CNN training step (8 x 512). Each variant is a copy of
``csrc/`` with one edit to ``roi_align.cu`` (a warp a bin, fewer samples'
taps in flight, other register caps and block sizes, the lanes' loads
channel by channel),
built into ``_build/k1_variants/<name>/`` and loaded in turn; each is held
against the plain version (``multilevel_roi_align_plain``) by the bf16 rule
of ``chip_smoke.py`` and timed by CUDA events, two rounds so the spread
shows. ``--baseline DIR`` builds the kernels of ``DIR`` (for example the
parent commit, unpacked by ``git archive``) and times its K1 through its
own C entry point, with the largest difference from this tree's output.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

from .variants import build_variants, copy_with_edits, time_ms, use_variant

SOURCE = "roi_align.cu"
VARIANTS = {
    "base": [],
    # a warp a bin: P * P warps a roi, each with its bin's S x samples
    "warp_per_bin": [
        ("""  if (unit >= num_items * P) return;
  const int item = unit / P;       // image * R + roi
  const int ph = unit - item * P;  // the warp's bin row
  T* dst = out + (size_t)unit * P * C;
""", """  if (unit >= num_items * P * P) return;
  const int item = unit / (P * P);  // image * R + roi
  const int ph = (unit - item * P * P) / P;
  const int pw0 = unit % P;         // the warp's bin
  T* dst = out + (size_t)unit * C;
"""),
        ("""    for (int pw = 0; pw < P; ++pw)
      for (int c0 = lane * kV; c0 < C; c0 += 32 * kV)
        L::store(dst + (size_t)pw * C + c0, zero, C - c0, vec_ok);""",
         """    for (int c0 = lane * kV; c0 < C; c0 += 32 * kV)
      L::store(dst + c0, zero, C - c0, vec_ok);"""),
        ("  for (int t = lane; t < S + P * S; t += 32) {",
         "  for (int t = lane; t < 2 * S; t += 32) {"),
        ("    const int kk = is_y ? ph * S + t : t - S;",
         "    const int kk = is_y ? ph * S + t : pw0 * S + (t - S);"),
        ("  for (int pw = 0; pw < P; ++pw) {\n    for (int c0",
         "  for (int pw = 0; pw < 1; ++pw) {\n    for (int c0"),
        ("  const long long units = (long long)num_items * P;  // bin rows",
         "  const long long units = (long long)num_items * P * P;  // bins"),
    ],
    "group_4": [("constexpr int kGroup = 2;", "constexpr int kGroup = 4;"),
                ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 4;")],
    "group_1": [("constexpr int kGroup = 2;", "constexpr int kGroup = 1;"),
                ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 8;")],
    "warps_8": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 3;")],
    "scalar_loads": [("const bool v16 = vec_ok;", "const bool v16 = false;")],
}


def make_variant(name: str, src_dir: str, root: str) -> str:
    """Copy ``src_dir`` (a csrc/) to ``root/csrc`` with variant ``name``'s
    edits applied to roi_align.cu; -> the copy's csrc directory."""
    return copy_with_edits(src_dir, root, SOURCE, VARIANTS[name])


def baseline_kernel(checkout: str):
    """Build ``checkout``'s kernels under ``_build/k1_variants/baseline/``;
    -> a function (features, rois, strides, levels, valid) -> its K1 output,
    called through its own C entry point (with or without the ``vec``
    argument this tree's takes)."""
    import torch

    from . import build

    src_dir, build_dir = build.CSRC_DIR, build.BUILD_DIR
    csrc = os.path.join(os.path.abspath(checkout), "mxdetection_tpu_torch", "csrc")
    try:
        build.CSRC_DIR = csrc
        build.BUILD_DIR = os.path.join(build_dir, "k1_variants", "baseline", "_build")
        path, secs, _ = build.build()
    finally:
        build.CSRC_DIR, build.BUILD_DIR = src_dir, build_dir
    print(f"built the baseline from {checkout} in {secs:.1f} s", flush=True)
    with open(os.path.join(csrc, SOURCE)) as f:
        takes_vec = "int is_bf16, int vec, void* stream" in f.read()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mxdet_roi_align_fwd.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, i] + \
        ([i] if takes_vec else []) + [p]
    lib.mxdet_roi_align_fwd.restype = i

    def run(features, rois, strides, levels, valid):
        b, r = rois.shape[:2]
        c = features[0].shape[-1]
        out = torch.empty((b, r, 7, 7, c), dtype=features[0].dtype, device=rois.device)
        n = len(features)
        args = [(ctypes.c_void_p * n)(*[f.data_ptr() for f in features]),
                (ctypes.c_int * n)(*[f.shape[1] for f in features]),
                (ctypes.c_int * n)(*[f.shape[2] for f in features]),
                (ctypes.c_float * n)(*[1.0 / float(s) for s in strides]), n, rois.data_ptr(),
                levels.int().data_ptr(), valid.data_ptr(), out.data_ptr(), b * r, r, c, 7, 2,
                int(out.dtype == torch.bfloat16)]
        args += [int(c * out.element_size() % 16 == 0)] if takes_vec else []
        build.check(lib.mxdet_roi_align_fwd(*args, torch.cuda.current_stream().cuda_stream),
                    "baseline mxdet_roi_align_fwd")
        return out

    return run


def main() -> int:
    import torch

    from . import build
    from .roi_align import roi_align_cuda
    from ..roi_align import multilevel_roi_align_plain, roi_levels

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rois", help="the roi sets saved by chip_smoke.py --k3-rois")
    parser.add_argument("--baseline", help="a checkout whose K1 kernel to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run only on the card")
    sys.path.insert(0, os.getcwd())  # chip_smoke.py, at the root of the checkout
    import chip_smoke

    strides, shapes = (4, 8, 16, 32), [(208, 336), (104, 168), (52, 84), (26, 42)]
    rois, valid = chip_smoke.main_path_rois(8, 1000, torch.Generator().manual_seed(1), "cuda")
    levels = roi_levels(rois, 4, min_level=2, canonical_scale=224.0, canonical_level=4)
    sets = {"phase2": (rois, levels, valid)}
    if args.rois:
        saved = torch.load(args.rois)["sets"]["train_step"]
        sets["train_step"] = tuple(saved[k].cuda() for k in ("rois", "levels", "valid"))
    gen = torch.Generator().manual_seed(0)
    cases = []
    for name, (rois, levels, valid) in sets.items():
        feats = [torch.randn((rois.shape[0], h, w, 256), generator=gen).cuda().bfloat16()
                 for h, w in shapes]
        ref = multilevel_roi_align_plain(feats, rois, strides, levels, roi_valid=valid)
        cases.append((name, feats, rois, levels.int(), valid, ref))
        print(f"{name}: {int(valid.sum())} valid rois of {tuple(valid.shape)}, rois a level "
              f"{torch.bincount(levels[valid].long(), minlength=4).tolist()}", flush=True)
    card = torch.cuda.get_device_name(0)
    if args.baseline:
        old = baseline_kernel(args.baseline)
        for name, feats, rois, levels, valid, _ in cases:
            new = roi_align_cuda(feats, rois, strides, levels, roi_valid=valid)
            diff = (old(feats, rois, strides, levels, valid).float() - new.float()).abs().max()
            ms = [time_ms(lambda: old(feats, rois, strides, levels, valid)),
                  time_ms(lambda: roi_align_cuda(feats, rois, strides, levels, roi_valid=valid))]
            ms += [time_ms(lambda: roi_align_cuda(feats, rois, strides, levels, roi_valid=valid)),
                   time_ms(lambda: old(feats, rois, strides, levels, valid))]
            print(f"card: {card}; {name}: baseline {ms[0]:.4f} / {ms[3]:.4f} ms, this tree "
                  f"{ms[1]:.4f} / {ms[2]:.4f} ms (bf16, in turns); largest difference "
                  f"{diff.item():.3e}", flush=True)
    own = (build.CSRC_DIR, build.BUILD_DIR)
    libs = build_variants(VARIANTS, make_variant, "k1_variants")
    print(f"card: {card}; ms per call, bf16, on each roi set")
    try:
        for rnd in range(2):
            for vname, dirs in libs.items():
                use_variant(dirs)
                parts, ok = [], True
                for name, feats, rois, levels, valid, ref in cases:
                    got = roi_align_cuda(feats, rois, strides, levels, roi_valid=valid).float()
                    err = (got - ref.float()).abs()
                    ok &= bool((err <= 2.0 ** -7 * ref.float().abs() + 1e-5).all())
                    ms = time_ms(lambda: roi_align_cuda(feats, rois, strides, levels,
                                                        roi_valid=valid))
                    parts.append(f"{name} {ms:.4f}")
                print(f"round {rnd} {vname:14s} {'ok' if ok else 'wrong'} " + ", ".join(parts),
                      flush=True)
    finally:
        use_variant(own)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
