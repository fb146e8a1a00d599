"""Time variants of the fused deformable-conv weight-gradient kernel (K6/K6b,
``csrc/deform_conv_bwd.cu::wg::wgrad_kernel``) on the card, to see what
bounds it.

Run from the root of a checkout on a machine with a CUDA card::

    python -m mxdetection_tpu_torch.ops.cuda.k6_variants [--baseline DIR]

Each variant is a copy of ``csrc/`` with one edit to ``deform_conv_bwd.cu``,
built into ``_build/k6_variants/<name>/`` and loaded in turn. Some edits
keep the function (the depth of the load prefetch, the number of stages,
dpatch read through L1, one slice of M, so no cross-block sum of dW); the others take a piece of
work out (the corner gather, the dpatch read, the offset gradient, the
wgmma, g's copies, the final cross-block sum), so their outputs are wrong
and only their times mean anything. Every variant is checked against the
plain version (``ops/dcn.py::deform_wgrad_doffsets``), its largest error
printed as a share of the largest value and marked ``ok`` within 1e-4,
else ``wrong``. Times are CUDA-event means of
the wrapper (``deform_wgrad_doffsets_cuda``, its layout pass and final sum
included) on bf16 inputs at the six DCN layer shapes of Cascade R101-DCN at
batch 8, 832x1344 (offsets of std 1.5 cells, seed 0), and K6 / K6b summed
over the layers of a training step, as ``chip_smoke.py`` sums them. Two
rounds, so the spread between rounds shows beside the differences between
variants.

``--baseline DIR`` also times, on the same inputs, another checkout's
patches kernel (the unfused K6 of the tree before the fused kernel, built
from ``DIR/mxdetection_tpu_torch/csrc`` and called through its C entry
point ``mxdet_deform_patches_doffsets``) followed by the dW matmul it fed
(``ops/dcn.py::_matmul_f32``), with the peak memory of each route.

``--ab NAME=CSRC ...`` times, in place of the variants, the kernels built
from whole copies of ``csrc/`` (versions too different for a text edit),
in turns a, b, ..., b, a, through this tree's wrapper (their C entry point
must match it)::

    python -m mxdetection_tpu_torch.ops.cuda.k6_variants --ab old=DIR1/csrc new=DIR2/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os

from .variants import LAYERS, build_variants, copy_with_edits, time_ms, use_variant

SOURCE = "deform_conv_bwd.cu"
WGMMA = ("        wgmma_bf16<BN, 1>(acc, smem_desc_mn(a + 16 * kRowBytes * kk, C::kBlockBytes),\n"
         "                          smem_desc_mn(b + 16 * kRowBytes * kk, C::kBlockBytes));")
VARIANTS = {
    "base": [],
    "ahead_1": [("constexpr int kAhead = 0;", "constexpr int kAhead = 1;")],
    "ahead_2": [("constexpr int kAhead = 0;", "constexpr int kAhead = 2;")],
    "stages_2": [("static constexpr int kStages = 3;", "static constexpr int kStages = 2;")],
    "stages_4": [("static constexpr int kStages = 3;", "static constexpr int kStages = 4;")],
    "dpatch_via_l1": [("f.d[u] = load_stream(dpatch + (size_t)m * (kTaps * g.Cin) + t * g.Cin + c0 + "
                       "vec * 8);", "f.d[u] = __ldg(reinterpret_cast<const uint4*>(dpatch + "
                       "(size_t)m * (kTaps * g.Cin) + t * g.Cin + c0 + vec * 8));")],
    "one_slice": [("constexpr int kWgMaxSlices = 16;", "constexpr int kWgMaxSlices = 1;")],
    # below: a piece of work taken out, for its time only
    "no_gather": [(f"f.q[u][{q}] = __ldg(reinterpret_cast<const uint4*>(xv + off.{c}));",
                   f"f.q[u][{q}] = make_uint4(off.{c}, vec, {q}, 0u);")
                  for q, c in enumerate("xyzw")],
    "no_dpatch_read": [("    if (with_doff && m < g.M)\n      f.d[u] = load_stream(",
                        "    if (false)\n      f.d[u] = load_stream(")],
    "no_offset_grad": [("const bool with_doff = nt == 0;", "const bool with_doff = false;")],
    "no_wgmma": [(WGMMA, "        acc[kk] += 1.0f;")],
    "no_g_copy": [("          mbar_arrive_expect_tx(&full[s], C::kBBytes);",
                   "          mbar_arrive(&full[s]);\n          if (false)")],
    "no_final_sum": [("  wgrad_finish_kernel<<<", "  if (false) wgrad_finish_kernel<<<")],
}


def make_variant(name: str, src_dir: str, root: str) -> str:
    """Copy ``src_dir`` (a csrc/) to ``root/csrc`` with variant ``name``'s
    edits applied to deform_conv_bwd.cu; -> the copy's csrc directory."""
    return copy_with_edits(src_dir, root, SOURCE, VARIANTS[name])


def baseline_patches(checkout: str):
    """Build ``checkout``'s kernels under ``_build/k6_variants/baseline/``;
    -> a function (x, offsets, dpatch, stride) -> (patches, doffsets) that
    calls its ``mxdet_deform_patches_doffsets``, as its wrapper did."""
    import torch

    from . import build

    src_dir, build_dir = build.CSRC_DIR, build.BUILD_DIR
    try:
        build.CSRC_DIR = os.path.join(os.path.abspath(checkout), "mxdetection_tpu_torch", "csrc")
        build.BUILD_DIR = os.path.join(build_dir, "k6_variants", "baseline", "_build")
        path, secs, _ = build.build()
    finally:
        build.CSRC_DIR, build.BUILD_DIR = src_dir, build_dir
    print(f"built the baseline from {checkout} in {secs:.1f} s", flush=True)
    fn = ctypes.CDLL(path).mxdet_deform_patches_doffsets
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = i

    def patches_doffsets(x, offsets, dpatch, stride):
        b, h, w, c = x.shape
        patches = torch.empty_like(dpatch)
        doff = torch.empty(offsets.shape, dtype=torch.float32, device=x.device)
        build.check(fn(x.data_ptr(), offsets.data_ptr(), dpatch.data_ptr(), patches.data_ptr(),
                       doff.data_ptr(), b, h, w, c, offsets.shape[1], offsets.shape[2], stride, 1,
                       -1.0, int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream),
                    "baseline mxdet_deform_patches_doffsets")
        return patches, doff

    return patches_doffsets


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
    from . import deform_conv as dc
    from ..dcn import _matmul_f32, deform_wgrad_doffsets

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="a checkout whose unfused K6 and dW matmul to time "
                                           "beside")
    parser.add_argument("--ab", nargs="+", metavar="NAME=CSRC",
                        help="time the kernels built from these csrc directories in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = baseline_patches(args.baseline) if args.baseline else None
    own = (build.CSRC_DIR, build.BUILD_DIR)
    if args.ab:
        dirs = dict(a.split("=", 1) for a in args.ab)
        libs = build_variants(dirs, lambda name, _, root: copy_with_edits(
            os.path.abspath(dirs[name]), root, SOURCE, []), "k6_ab")
        order = [(f"turn {i}", name) for i, name in enumerate(list(libs) + list(libs)[::-1])]
    else:
        libs = build_variants(VARIANTS, make_variant, "k6_variants")
        order = [(f"round {r}", name) for r in range(2) for name in libs]

    gen = torch.Generator().manual_seed(0)
    cases = []
    for h, w, c, stride, n in LAYERS:
        ho, wo = -(-h // stride), -(-w // stride)
        x = torch.randn((8, h, w, c), generator=gen).cuda().bfloat16()
        off = (torch.randn((8, ho, wo, 18), generator=gen) * 1.5).cuda()
        wt = (torch.randn((3, 3, c, c), generator=gen) * (2.0 / (9 * c)) ** 0.5).cuda().bfloat16()
        g = torch.randn((8 * ho * wo, c), generator=gen).cuda().bfloat16()
        dp = (g @ wt.reshape(9 * c, c).t()).reshape(8, ho, wo, 9 * c)
        ref = deform_wgrad_doffsets(x, off, dp, g, stride=stride)
        cases.append((f"{h}x{w}x{c} s{stride}", stride, n, x, off, dp, g, ref))

    card = torch.cuda.get_device_name(0)
    if base:
        print(f"card: {card}; ms per call and peak MiB above the inputs, the unfused route "
              "(patches kernel, then the dW matmul) beside the fused kernel", flush=True)
        for shape, stride, n, x, off, dp, g, ref in cases:
            def old():
                patches, doff = base(x, off, dp, stride)
                return _matmul_f32(patches.reshape(g.shape[0], -1).t(), g), doff
            fused = lambda: dc.deform_wgrad_doffsets_cuda(x, off, dp, g, stride=stride)  # noqa: E731
            got = old()
            right = all(bool(((o - r).abs().max() <= 1e-4 * r.abs().max()).item())
                        for o, r in zip(got, ref))
            patches = base(x, off, dp, stride)[0].reshape(g.shape[0], -1)
            ms = {k: [] for k in ("old", "old_k6", "old_mm", "fused")}
            for _ in range(2):
                ms["old"].append(time_ms(old))
                ms["old_k6"].append(time_ms(lambda: base(x, off, dp, stride)))
                ms["old_mm"].append(time_ms(lambda: _matmul_f32(patches.t(), g)))
                ms["fused"].append(time_ms(fused))
            del patches, got
            print(f"{shape} x{n}: old K6 + dW matmul {ms['old'][0]:.4f} / {ms['old'][1]:.4f} ms "
                  f"({'ok' if right else 'wrong'}; K6 {ms['old_k6'][0]:.4f}, matmul "
                  f"{ms['old_mm'][0]:.4f}), peak {peak_mib(old):.1f} MiB; fused "
                  f"{ms['fused'][0]:.4f} / {ms['fused'][1]:.4f} ms, peak {peak_mib(fused):.1f} MiB",
                  flush=True)

    print(f"card: {card}; ms per call, K6 / K6b per training step")
    try:
        for label, name in order:
            use_variant(libs[name])
            worst, total, per_shape = 0.0, {1: 0.0, 2: 0.0}, []
            for shape, stride, n, x, off, dp, g, ref in cases:
                got = dc.deform_wgrad_doffsets_cuda(x, off, dp, g, stride=stride)
                errs = [((o - r).abs().max() / r.abs().max()).item() for o, r in zip(got, ref)]
                worst = max([worst] + [e if math.isfinite(e) else math.inf for e in errs])
                ms = time_ms(lambda: dc.deform_wgrad_doffsets_cuda(x, off, dp, g, stride=stride))
                total[stride] += n * ms
                per_shape.append(f"{shape} {ms:.4f}")
            print(f"{label} {name:16s} {'ok' if worst <= 1e-4 else 'wrong'} (largest error "
                  f"{worst:.1e} of the largest value) K6 {total[1]:.3f} K6b {total[2]:.3f}; "
                  + ", ".join(per_shape), flush=True)
    finally:
        use_variant(own)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
