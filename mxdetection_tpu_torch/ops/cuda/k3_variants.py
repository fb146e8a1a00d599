"""Time the RoIAlign backward (K3, with the bf16 convert K3b as its
epilogue, ``csrc/roi_align_bwd.cu``) on the card, beside edited copies of it
and, with ``--baseline DIR``, beside another checkout's route: a zeroed f32
accumulator, the atomic K3 kernel and the separate K3b convert.

Run from the root of a checkout on a machine with a CUDA card, on the roi
sets that ``chip_smoke.py --k3-rois FILE`` saved (its phase 5 rois and the
rois of one Faster R-CNN training step's sampler)::

    python3 chip_smoke.py --k3-rois chiprun_out/k3_rois.pt
    python -m mxdetection_tpu_torch.ops.cuda.k3_variants chiprun_out/k3_rois.pt \\
        [--baseline DIR]

Each variant is a copy of ``csrc/`` with one edit to ``roi_align_bwd.cu``,
built into ``_build/k3_variants/<name>/`` and loaded in turn. Some edits keep
the function (the tile's shape, the blocks an SM must hold, g read from
memory instead of the shared-memory stage); the others take a piece of work
out (the g loads, the sums, the stage's copies, every roi group: the list
scans and the stores alone), so their outputs are wrong and only their
times mean anything. Every variant is checked against autograd
of the plain version (``ops/roi_align.py::multilevel_roi_align_plain``) in
f32, its largest error printed as a share of the largest value and marked
``ok`` within 1e-5, else ``wrong``. Times are CUDA-event means of the
wrapper (``roi_align_bwd_cuda``, its footprint pass included) with a bf16
upstream gradient (B, R, 7, 7, 256), seeded, and bf16 level gradients out,
P2-P5 of 832x1344, two rounds so the spread between rounds shows beside the
differences. ``--baseline DIR`` builds the kernels of ``DIR`` (for example
the parent commit, unpacked by ``git archive``) and times its route through
its own C entry points, with the peak memory of each route.
"""

from __future__ import annotations

import argparse
import ctypes
import os

from .variants import build_variants, copy_with_edits, time_ms, use_variant

SOURCE = "roi_align_bwd.cu"
TILE = "constexpr int kTH = 8, kTW = 4;"
BLOCKS = "constexpr int kMinBlocks = 3;"
SUM = "for (int j = 0; j < kCV; ++j) acc[x][j] = __fadd_rn(acc[x][j], __fmul_rn(gv[j], ab));"
VARIANTS = {
    "base": [],
    "tile_8x8": [(TILE, "constexpr int kTH = 8, kTW = 8;"),
                 (BLOCKS, "constexpr int kMinBlocks = 2;")],
    "min_blocks_2": [(BLOCKS, "constexpr int kMinBlocks = 2;")],
    "min_blocks_4": [(BLOCKS, "constexpr int kMinBlocks = 4;"),
                     ("kStageBytes = 52 * 1024;", "kStageBytes = 36 * 1024;")],
    "no_stage": [("kStageBytes = 52 * 1024;", "kStageBytes = 0;")],
    # below: a piece of work taken out, for its time only
    "no_g_load": [("load_g(grow + (bin[1][kx] - c0) * bin_elems, kStaged || vec, kStaged ? kCV : "
                   "nleft, gv);", "for (int j = 0; j < kCV; ++j) gv[j] = (float)(kx + j);")],
    "no_sums": [(SUM, "for (int j = 0; j < kCV; ++j) acc[x][j] += ab;")],
    "no_stage_copy": [("            cp_async16(to, from);", "            (void)from;")],
    "no_groups": [("    for (int g0 = 0; g0 < total;) {", "    for (int g0 = total; g0 < total;) {")],
}


def make_variant(name: str, src_dir: str, root: str) -> str:
    """Copy ``src_dir`` (a csrc/) to ``root/csrc`` with variant ``name``'s
    edits applied to roi_align_bwd.cu; -> the copy's csrc directory."""
    return copy_with_edits(src_dir, root, SOURCE, VARIANTS[name])


def baseline_route(checkout: str):
    """Build ``checkout``'s kernels under ``_build/k3_variants/baseline/``;
    -> a function (g, shapes, strides, rois, levels, valid) -> bf16 level
    gradients that runs its route as its wrapper did: a zeroed f32 buffer for
    every level, ``mxdet_roi_align_bwd`` (f32 atomics into it) and
    ``mxdet_f32_to_bf16``."""
    import torch

    from . import build

    src_dir, build_dir = build.CSRC_DIR, build.BUILD_DIR
    try:
        build.CSRC_DIR = os.path.join(os.path.abspath(checkout), "mxdetection_tpu_torch", "csrc")
        build.BUILD_DIR = os.path.join(build_dir, "k3_variants", "baseline", "_build")
        path, secs, _ = build.build()
    finally:
        build.CSRC_DIR, build.BUILD_DIR = src_dir, build_dir
    print(f"built the baseline from {checkout} in {secs:.1f} s", flush=True)
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mxdet_roi_align_bwd.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, i, p]
    lib.mxdet_f32_to_bf16.argtypes = [p, p, ctypes.c_longlong, p]
    lib.mxdet_roi_align_bwd.restype = lib.mxdet_f32_to_bf16.restype = i

    def route(g, shapes, strides, rois, levels, valid):
        b, r, p_, _, c = g.shape
        sizes = [b * h * w * c for h, w in shapes]
        acc = torch.zeros(sum(sizes), dtype=torch.float32, device=g.device)
        n = len(shapes)
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.mxdet_roi_align_bwd(
            (ctypes.c_void_p * n)(*[v.data_ptr() for v in acc.split(sizes)]),
            (ctypes.c_int * n)(*[h for h, _ in shapes]), (ctypes.c_int * n)(*[w for _, w in shapes]),
            (ctypes.c_float * n)(*[1.0 / float(s) for s in strides]), n, rois.data_ptr(),
            levels.data_ptr(), valid.data_ptr(), g.data_ptr(), b * r, r, c, p_, 2,
            int(g.dtype == torch.bfloat16), stream), "baseline mxdet_roi_align_bwd")
        out = torch.empty(acc.shape, dtype=torch.bfloat16, device=g.device)
        build.check(lib.mxdet_f32_to_bf16(acc.data_ptr(), out.data_ptr(), acc.numel(), stream),
                    "baseline mxdet_f32_to_bf16")
        return [v.view(b, h, w, c) for v, (h, w) in zip(out.split(sizes), shapes)]

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


def main() -> int:
    import torch

    from . import build
    from . import roi_align as ra
    from ..roi_align import multilevel_roi_align_plain

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("rois", help="the roi sets saved by chip_smoke.py --k3-rois")
    parser.add_argument("--baseline", help="a checkout whose zero + K3 + K3b route to time "
                                           "beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run only on the card")
    saved = torch.load(args.rois)
    shapes, strides = [tuple(s) for s in saved["shapes"]], tuple(saved["strides"])
    base = baseline_route(args.baseline) if args.baseline else None
    own = (build.CSRC_DIR, build.BUILD_DIR)
    libs = build_variants(VARIANTS, make_variant, "k3_variants")

    gen = torch.Generator().manual_seed(0)
    cases = []
    for name, s in saved["sets"].items():
        rois, levels, valid = (s[k].cuda() for k in ("rois", "levels", "valid"))
        b, r = valid.shape
        g = torch.randn((b, r, 7, 7, 256), generator=gen).cuda().bfloat16()
        leaves = [torch.zeros((b, h, w, 256), device="cuda", requires_grad=True)
                  for h, w in shapes]
        out = multilevel_roi_align_plain(leaves, rois, strides, levels, roi_valid=valid)
        ref = torch.autograd.grad(out, leaves, g.float())
        taps = ra.roi_sample_taps(rois, levels, shapes, strides)
        pairs, longest = ra.roi_tile_pairs(ra.roi_footprints(taps, valid), levels, shapes)
        print(f"{name}: {int(valid.sum())} valid rois of {b}x{r}, rois a level "
              f"{torch.bincount(levels[valid].long(), minlength=len(shapes)).tolist()}; "
              f"{pairs} (roi, tile) pairs, longest list {longest}", flush=True)
        cases.append((name, g, rois, levels, valid, ref))

    card = torch.cuda.get_device_name(0)
    if base:
        print(f"card: {card}; ms per call and peak MiB above the inputs, bf16 out: the "
              "baseline route (zero + atomic K3 + K3b) beside this tree's", flush=True)
        for name, g, rois, levels, valid, ref in cases:
            old = lambda: base(g, shapes, strides, rois, levels.int(), valid)  # noqa: E731
            new = lambda: ra.roi_align_bwd_cuda(g, shapes, rois, strides, levels,  # noqa: E731
                                                roi_valid=valid, out_dtype=torch.bfloat16)
            scale = max(x.abs().max().item() for x in ref)
            err = max((o.float() - n.float()).abs().max().item() for o, n in zip(old(), new()))
            ms = {"old": [], "new": []}
            for _ in range(2):
                ms["old"].append(time_ms(old))
                ms["new"].append(time_ms(new))
            print(f"{name}: baseline {ms['old'][0]:.4f} / {ms['old'][1]:.4f} ms, peak "
                  f"{peak_mib(old):.1f} MiB; this tree {ms['new'][0]:.4f} / {ms['new'][1]:.4f} ms, "
                  f"peak {peak_mib(new):.1f} MiB; largest bf16 difference {err:.3e} "
                  f"({err / scale:.1e} of the largest value)", flush=True)

    print(f"card: {card}; ms per call, bf16 out, on each roi set")
    try:
        for rnd in range(2):
            for vname, dirs in libs.items():
                use_variant(dirs)
                parts, worst = [], 0.0
                for name, g, rois, levels, valid, ref in cases:
                    got = ra.roi_align_bwd_cuda(g, shapes, rois, strides, levels,
                                                roi_valid=valid, out_dtype=torch.float32)
                    scale = max(x.abs().max().item() for x in ref)
                    worst = max([worst] + [(a - e).abs().max().item() / scale
                                           for a, e in zip(got, ref)])
                    ms = time_ms(lambda: ra.roi_align_bwd_cuda(
                        g, shapes, rois, strides, levels, roi_valid=valid,
                        out_dtype=torch.bfloat16))
                    parts.append(f"{name} {ms:.4f}")
                print(f"round {rnd} {vname:16s} {'ok' if worst <= 1e-5 else 'wrong'} (largest "
                      f"error {worst:.1e} of the largest value) " + ", ".join(parts), flush=True)
    finally:
        use_variant(own)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
