"""Time variants of the bf16 deformable-conv forward kernel (K5/K5b,
``csrc/deform_conv.cu``) on the card, to see what bounds it.

Run from the root of a checkout on a machine with a CUDA card::

    python -m mxdetection_tpu_torch.ops.cuda.k5_variants

Each variant is a copy of ``csrc/`` with one edit to ``deform_conv.cu``,
built into ``_build/k5_variants/<name>/`` and loaded in turn. Some edits
keep the function (the depth of the load prefetch, the number of stages,
one barrier arrival a warp instead of a thread); the others take a piece of
work out (the corner loads, W's copies, the wgmma, the epilogue's stores,
the proxy fence, all but one or two channel chunks), so their outputs are
wrong and only their times mean anything. Every variant is checked against
the plain version (``ops/dcn.py::deform_conv2d``) within two bf16 roundings
and marked ``ok`` or ``wrong``. Times are CUDA-event means of the wrapper
(``deform_conv2d_cuda``) at the six DCN layer shapes of Cascade R101-DCN at
batch 8, 832x1344 (offsets of std 1.5 cells, seed 0), and K5 / K5b summed
over the layers of a batch, as ``chip_smoke.py`` sums them. Two rounds, so
the spread between rounds shows beside the differences between variants.
"""

from __future__ import annotations

from . import build
from .variants import LAYERS, build_variants, copy_with_edits, time_ms, use_variant

FENCE = ('        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");'
         '  // visible to wgmma\n')
VARIANTS = {
    "base": [],
    "chunks_ahead_0": [("kChunksAhead = 2;", "kChunksAhead = 0;")],
    "chunks_ahead_1": [("kChunksAhead = 2;", "kChunksAhead = 1;")],
    "chunks_ahead_3": [("kChunksAhead = 2;", "kChunksAhead = 3;")],
    "stages_3": [("static constexpr int kStages = 4;", "static constexpr int kStages = 3;")],
    "stages_6": [("static constexpr int kStages = 4;",
                  "static constexpr int kStages = BN == 256 ? 4 : 6;")],
    "arrive_per_warp": [
        ("mbar_init(&full[s], kProducerThreads + 1);",
         "mbar_init(&full[s], kProducerThreads / 32 + 1);"),
        ("mbar_init(&empty[s], kConsumerThreads);", "mbar_init(&empty[s], kConsumerThreads / 32);"),
        ("        mbar_arrive(&full[s]);\n",
         "        __syncwarp();\n        if (threadIdx.x % 32 == 0) mbar_arrive(&full[s]);\n"),
        ("      if (i > 0) mbar_arrive(",
         "      if (i > 0 && threadIdx.x % 32 == 0) mbar_arrive(")],
    # below: a piece of work taken out, for its time only
    "no_fence": [(FENCE, "")],
    "no_corner_loads": [(f"f.q[u][{q}] = __ldg(reinterpret_cast<const uint4*>(xv + off.{c}));",
                         f"f.q[u][{q}] = make_uint4(off.{c}, cc, vec, {q});")
                        for q, c in enumerate("xyzw")],
    "no_w_copy": [("mbar_arrive_expect_tx(&full[s], C::kBBytes);",
                   "mbar_arrive(&full[s]);\n          if (false)")],
    "no_wgmma": [("wgmma_bf16<BN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));",
                  "acc[kk] += 1.0f;")],
    "no_epilogue_stores": [("      if (row < g.M)\n", "      if (row < -g.M)\n"),
                           ("      if (row + 8 < g.M)\n", "      if (row + 8 < -g.M)\n")],
    "chunks_1": [("  const int chunks = g.Cin / kBK;", "  const int chunks = 1;")],
    "chunks_2": [("  const int chunks = g.Cin / kBK;", "  const int chunks = 2;")],
}


def make_variant(name: str, src_dir: str, root: str) -> str:
    """Copy ``src_dir`` (a csrc/) to ``root/csrc`` with variant ``name``'s
    edits applied to deform_conv.cu; -> the copy's csrc directory."""
    return copy_with_edits(src_dir, root, "deform_conv.cu", VARIANTS[name])


def main() -> int:
    import torch

    from . import deform_conv as dc
    from ..dcn import deform_conv2d

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the variants run only on the card")
    own = (build.CSRC_DIR, build.BUILD_DIR)
    libs = build_variants(VARIANTS, make_variant, "k5_variants")

    gen = torch.Generator().manual_seed(0)
    cases = []
    for h, w, c, stride, n in LAYERS:
        ho, wo = -(-h // stride), -(-w // stride)
        x = torch.randn((8, h, w, c), generator=gen).cuda().bfloat16()
        off = (torch.randn((8, ho, wo, 18), generator=gen) * 1.5).cuda()
        wt = (torch.randn((3, 3, c, c), generator=gen) * (2.0 / (9 * c)) ** 0.5).cuda().bfloat16()
        ref = deform_conv2d(x, off, wt, stride=stride).float()
        cases.append((f"{h}x{w}x{c} s{stride}", stride, n, x, off, wt, ref))

    print(f"card: {torch.cuda.get_device_name(0)}; ms per call, K5 / K5b per batch")
    try:
        for rnd in range(2):
            for name, dirs in libs.items():
                use_variant(dirs)
                right, total, per_shape = True, {1: 0.0, 2: 0.0}, []
                for shape, stride, n, x, off, wt, ref in cases:
                    got = dc.deform_conv2d_cuda(x, off, wt, stride=stride).float()
                    tol = 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()
                    right &= bool(((got - ref).abs() <= tol).all())
                    ms = time_ms(lambda: dc.deform_conv2d_cuda(x, off, wt, stride=stride))
                    total[stride] += n * ms
                    per_shape.append(f"{shape} {ms:.4f}")
                print(f"round {rnd} {name:20s} {'ok' if right else 'wrong'} K5 {total[1]:.3f} "
                      f"K5b {total[2]:.3f}; " + ", ".join(per_shape), flush=True)
    finally:
        use_variant(own)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
