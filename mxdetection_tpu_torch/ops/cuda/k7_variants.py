"""Time variants of the deformable-conv dx kernel (K7/K7b,
``csrc/deform_conv_bwd.cu::deform_col2im_kernel``) on the card, to see what
bounds it.

Run from the root of a checkout on a machine with a CUDA card::

    python -m mxdetection_tpu_torch.ops.cuda.k7_variants

Each variant is a copy of ``csrc/`` with one edit to ``deform_conv_bwd.cu``,
built into ``_build/k7_variants/<name>/`` and loaded in turn. Some edits
keep the function: the window's reach, the tile shapes, the channels a
lane sums (with the tile that fits), the block size, the grid's size, and
every corner spilled straight into dx (the atomic traffic
of the kernel before the window, through the new code). The others take a
piece of work out (the flush's atomics, the sums, the staging of dpatch),
so their outputs are wrong and only their times mean anything. Every
variant is checked against the plain version (``ops/dcn.py::deform_col2im``)
within 1e-4 of the largest value and marked ``ok`` or ``wrong``. Times are CUDA-event means of the
wrapper (``deform_col2im_cuda``, its zeroing of dx included) on bf16 dpatch
at the six DCN layer shapes of Cascade R101-DCN at batch 8, 832x1344, with
offsets of std 1.5 cells (``chip_smoke.py`` phase 10's) and of std 1 cell
(about the main path's), and K7 / K7b summed over the layers of a training
step, as ``chip_smoke.py`` sums them. Two rounds, so the spread between
rounds shows beside the differences between variants.

With ``--sweep`` it times the kernel instead against the share of corners
that spill out of its windows, at the stage-3 and the stride-2 stage-2
shape: offsets of std 1 to 6 cells (and std 6 with one value in a thousand
at +-40), then std 1 with a share of the taps moved to a uniform point of
the map (so their corners stay in the map and leave the window), each
beside the spill share of the plain model (``col2im_window_split``). ``--baseline DIR`` adds another checkout's
kernel, built from its ``DIR/mxdetection_tpu_torch/csrc`` and called through
the same C entry point (``mxdet_deform_col2im``, whose signature has not
changed since the kernel was first written), on the same inputs, so the
sweep shows where the window stops paying::

    python -m mxdetection_tpu_torch.ops.cuda.k7_variants --sweep --baseline <checkout>
"""

from __future__ import annotations

import argparse
import ctypes
import os

from .variants import LAYERS, build_variants, copy_with_edits, time_ms, use_variant

SOURCE = "deform_conv_bwd.cu"
TILE_S1 = "template <> struct Col2imTile<1> { static constexpr int kTH = 8, kTW = 4; };"
TILE_S2 = "template <> struct Col2imTile<2> { static constexpr int kTH = 4, kTW = 8; };"
VARIANTS = {
    "base": [],
    "reach_2": [("constexpr int kReach = 3;", "constexpr int kReach = 2;")],
    "reach_4": [("constexpr int kReach = 3;", "constexpr int kReach = 4;")],
    "tile_s1_4x8": [(TILE_S1, TILE_S1.replace("kTH = 8, kTW = 4", "kTH = 4, kTW = 8"))],
    "tile_s2_8x4": [(TILE_S2, TILE_S2.replace("kTH = 4, kTW = 8", "kTH = 8, kTW = 4"))],
    "lane_2_tiles_8x8": [("constexpr int kCV = 4;", "constexpr int kCV = 2;"),
                         (TILE_S1, TILE_S1.replace("kTW = 4", "kTW = 8")),
                         (TILE_S2, TILE_S2.replace("kTH = 4", "kTH = 8"))],
    "threads_256": [("constexpr int kC2Threads = 512;", "constexpr int kC2Threads = 256;")],
    "min_blocks_512": [("constexpr int kMinBlocks = 1024;", "constexpr int kMinBlocks = 512;")],
    "min_blocks_2048": [("constexpr int kMinBlocks = 1024;", "constexpr int kMinBlocks = 2048;")],
    "all_spill": [("if ((unsigned)wy < (unsigned)C::kWR && (unsigned)wx < (unsigned)C::kWC) "
                   "return wy * C::kWC + wx;", "if (false) return 0;")],
    # below: a piece of work taken out, for its time only
    "no_flush": [("add_lane(dx + ((size_t)(b * g.H + y) * g.W + x) * g.Cin + c, acc, lane, "
                  "c < g.Cin);", "add_lane(dx, acc, lane, c < -g.Cin);")],
    "no_sums": [("for (int it = lo; it < hi; ++it) {", "for (int it = hi; it < hi; ++it) {")],
    "no_stage": [("if (i < g.Ho && j < g.Wo && cu < g.Cin)\n        cp_async8(",
                  "if (false)\n        cp_async8(")],
}


def make_variant(name: str, src_dir: str, root: str) -> str:
    """Copy ``src_dir`` (a csrc/) to ``root/csrc`` with variant ``name``'s
    edits applied to deform_conv_bwd.cu; -> the copy's csrc directory."""
    return copy_with_edits(src_dir, root, SOURCE, VARIANTS[name])


SWEEP_SHAPES = [(52, 84, 256, 1), (208, 336, 128, 2)]  # input H, W, channels, stride
SWEEP_STDS = [1.0, 1.5, 3.0, 6.0, "6 +-40"]
SWEEP_UNIFORM = [0.1, 0.25, 0.5, 0.75, 1.0]  # shares of taps moved to a uniform point


def sweep_offsets(gen, x_shape, stride: int) -> dict:
    """{label: offsets (B, Ho, Wo, 18) f32 on the CPU} for the sweep."""
    import torch

    b, h, w, _ = x_shape
    ho, wo = -(-h // stride), -(-w // stride)
    unit = torch.randn((b, ho, wo, 3, 3, 2), generator=gen)
    far = torch.rand(unit.shape, generator=gen) < 1e-3
    out = {}
    for std in SWEEP_STDS:
        off = unit * (6.0 if isinstance(std, str) else std)
        if isinstance(std, str):
            off[far] = 40.0 * torch.sign(unit[far])
        out[f"std {std}"] = off
    # a tap of pixel (i, j) samples (i stride + ky - 1, j stride + kx - 1) + offset
    base_y = (torch.arange(ho) * stride).view(ho, 1, 1, 1) + torch.arange(3).view(1, 1, 3, 1) - 1
    base_x = (torch.arange(wo) * stride).view(1, wo, 1, 1) + torch.arange(3).view(1, 1, 1, 3) - 1
    anywhere = torch.stack([torch.rand((b, ho, wo, 3, 3), generator=gen) * (h - 1) - base_y,
                            torch.rand((b, ho, wo, 3, 3), generator=gen) * (w - 1) - base_x], -1)
    pick = torch.rand((b, ho, wo, 3, 3, 1), generator=gen)
    for share in SWEEP_UNIFORM:
        out[f"std 1, {share:.0%} of taps anywhere"] = torch.where(pick < share, anywhere, unit)
    return {k: v.reshape(b, ho, wo, 18).contiguous() for k, v in out.items()}


def baseline_col2im(checkout: str):
    """Build ``checkout``'s kernels under ``_build/k7_variants/baseline/``;
    -> a function (dpatch, offsets, x_shape, stride) -> dx, f32, that calls
    its ``mxdet_deform_col2im`` on a zeroed dx, as the wrapper does."""
    import torch

    from . import build

    src_dir, build_dir = build.CSRC_DIR, build.BUILD_DIR
    try:
        build.CSRC_DIR = os.path.join(os.path.abspath(checkout), "mxdetection_tpu_torch", "csrc")
        build.BUILD_DIR = os.path.join(build_dir, "k7_variants", "baseline", "_build")
        path, secs, _ = build.build()
    finally:
        build.CSRC_DIR, build.BUILD_DIR = src_dir, build_dir
    print(f"built the baseline from {checkout} in {secs:.1f} s", flush=True)
    fn = ctypes.CDLL(path).mxdet_deform_col2im
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = i

    def col2im(dpatch, offsets, x_shape, stride):
        b, h, w, c = x_shape
        dx = torch.zeros(x_shape, dtype=torch.float32, device=dpatch.device)
        build.check(fn(dpatch.data_ptr(), offsets.data_ptr(), dx.data_ptr(), b, h, w, c,
                       offsets.shape[1], offsets.shape[2], stride, 1, -1.0,
                       int(dpatch.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream), "baseline mxdet_deform_col2im")
        return dx

    return col2im


def sweep(baseline: str | None) -> int:
    """K7 (and the baseline's) ms per call on bf16 dpatch against the share
    of corners that spill; two rounds."""
    import torch

    from . import deform_conv as dc
    from ..dcn import deform_col2im

    base = baseline_col2im(baseline) if baseline else None
    gen = torch.Generator().manual_seed(0)
    print(f"card: {torch.cuda.get_device_name(0)}; ms per call on bf16 dpatch, batch 8 "
          "(the wrapper's zeroing of dx included)", flush=True)
    for h, w, c, stride in SWEEP_SHAPES:
        ho, wo = -(-h // stride), -(-w // stride)
        x_shape = (8, h, w, c)
        dp = torch.randn((8, ho, wo, 9 * c), generator=gen).cuda().bfloat16()
        for label, off in sweep_offsets(gen, x_shape, stride).items():
            off = off.cuda()
            share = dc.col2im_window_split(dp, off, x_shape, stride=stride)[2] / (8 * ho * wo * 36)
            ref = deform_col2im(dp, off, x_shape, stride=stride)
            runs = {"k7": lambda: dc.deform_col2im_cuda(dp, off, x_shape, stride=stride)}
            if base:
                runs["baseline"] = lambda: base(dp, off, x_shape, stride)
            ok = {name: bool(((fn() - ref).abs().max() <= 1e-4 * ref.abs().max()).item())
                  for name, fn in runs.items()}
            ms = {name: [] for name in runs}
            for _ in range(2):
                for name, fn in runs.items():
                    ms[name].append(time_ms(fn))
            line = [f"{name} {ms[name][0]:.4f} / {ms[name][1]:.4f} ms "
                    f"({'ok' if ok[name] else 'wrong'})" for name in runs]
            print(f"{h}x{w}x{c} s{stride}, offsets {label}: {100 * share:.3f} % of corners "
                  "spilled; " + "; ".join(line), flush=True)
            del off, ref
        del dp
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    import torch

    from . import build
    from . import deform_conv as dc
    from ..dcn import deform_col2im

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sweep", action="store_true",
                        help="time the kernel against the spill share instead of the variants")
    parser.add_argument("--baseline", help="with --sweep: a checkout whose kernel to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run only on the card")
    if args.sweep:
        return sweep(args.baseline)
    own = (build.CSRC_DIR, build.BUILD_DIR)
    libs = build_variants(VARIANTS, make_variant, "k7_variants")

    gen = torch.Generator().manual_seed(0)
    cases = []
    for h, w, c, stride, n in LAYERS:
        ho, wo = -(-h // stride), -(-w // stride)
        dp = torch.randn((8, ho, wo, 9 * c), generator=gen).cuda().bfloat16()
        unit = torch.randn((8, ho, wo, 18), generator=gen).cuda()
        offs = {std: unit * std for std in (1.5, 1.0)}
        refs = {std: deform_col2im(dp, off, (8, h, w, c), stride=stride)
                for std, off in offs.items()}
        spill = {std: dc.col2im_window_split(dp[:1], off[:1], (1, h, w, c), stride=stride)[2]
                 / (9 * 4 * ho * wo) for std, off in offs.items()}
        print(f"{h}x{w}x{c} s{stride}: base spill share of corners (image 0) "
              + ", ".join(f"std {std}: {share:.4f}" for std, share in spill.items()), flush=True)
        cases.append((f"{h}x{w}x{c} s{stride}", (8, h, w, c), stride, n, dp, offs, refs))

    print(f"card: {torch.cuda.get_device_name(0)}; ms per call, K7 / K7b per training step "
          "(offsets of std 1.5 cells; std 1 in brackets)")
    try:
        for rnd in range(2):
            for name, dirs in libs.items():
                use_variant(dirs)
                right, total, per_shape = True, {(s, std): 0.0 for s in (1, 2)
                                                 for std in (1.5, 1.0)}, []
                for shape, x_shape, stride, n, dp, offs, refs in cases:
                    ms = {}
                    for std, off in offs.items():
                        got = dc.deform_col2im_cuda(dp, off, x_shape, stride=stride)
                        ref = refs[std]
                        right &= bool(((got - ref).abs().max() <= 1e-4 * ref.abs().max()).item())
                        ms[std] = time_ms(lambda: dc.deform_col2im_cuda(dp, off, x_shape,
                                                                        stride=stride))
                        total[(stride, std)] += n * ms[std]
                    per_shape.append(f"{shape} {ms[1.5]:.4f} ({ms[1.0]:.4f})")
                print(f"round {rnd} {name:18s} {'ok' if right else 'wrong'} K7 "
                      f"{total[(1, 1.5)]:.3f} ({total[(1, 1.0)]:.3f}) K7b {total[(2, 1.5)]:.3f} "
                      f"({total[(2, 1.0)]:.3f}); " + ", ".join(per_shape), flush=True)
    finally:
        use_variant(own)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
