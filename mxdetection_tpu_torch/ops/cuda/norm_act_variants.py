"""Time the FrozenBN epilogue kernels (``csrc/norm_act.cu``) on the card,
beside edited copies of them.

Run from the root of a checkout on a machine with a CUDA card::

    python -m mxdetection_tpu_torch.ops.cuda.norm_act_variants [--only NAMES]

At every (pattern, C, H, W) of R50 and R101 on the 832x1344 canvas
(``SHAPES``), bf16: the forward at batch 32 and the backward at batch 8,
each launched through its C entry point with the pointers bound once
(``kernel_fwd``, ``kernel_bwd``), so the time is the kernel's and not the
Python wrapper's; CUDA events, two rounds. Each variant is a copy of
``csrc/`` with an edit to ``norm_act.cu`` (another count of blocks an SM),
built into
``_build/norm_act_variants/<name>/`` and loaded in turn; its outputs must
equal the package's kernel bit for bit. Prints one line a variant: the
forward ms of an R50 batch of 32 (each shape times its calls) and the
backward ms of an R50 batch of 8, against the byte bounds.
"""

from __future__ import annotations

import argparse

from . import build
from .variants import build_variants, copy_with_edits, time_ms, use_variant

SOURCE = "norm_act.cu"
# (pattern, C, H, W, calls an R50 forward, calls an R101 forward). "a": a
# norm and its ReLU (the stem, every block's bn1 and bn2); "b_downsample" /
# "b_identity": bn3, the residual (the downsample conv's output through its
# BN, or the block's input) and the block's last ReLU.
SHAPES = [
    ("a", 64, 416, 672, 1, 1),
    ("a", 64, 208, 336, 6, 6),
    ("b_downsample", 256, 208, 336, 1, 1),
    ("b_identity", 256, 208, 336, 2, 2),
    ("a", 128, 208, 336, 1, 1),
    ("a", 128, 104, 168, 7, 7),
    ("b_downsample", 512, 104, 168, 1, 1),
    ("b_identity", 512, 104, 168, 3, 3),
    ("a", 256, 104, 168, 1, 1),
    ("a", 256, 52, 84, 11, 45),
    ("b_downsample", 1024, 52, 84, 1, 1),
    ("b_identity", 1024, 52, 84, 5, 22),
    ("a", 512, 52, 84, 1, 1),
    ("a", 512, 26, 42, 5, 5),
    ("b_downsample", 2048, 26, 42, 1, 1),
    ("b_identity", 2048, 26, 42, 2, 2),
]
HBM_BYTES_PER_S = 3.35e12

VARIANTS = {
    "base": [],
    "blocks4": [("constexpr int kBlocksPerSm = 8;", "constexpr int kBlocksPerSm = 4;")],
    "blocks16": [("constexpr int kBlocksPerSm = 8;", "constexpr int kBlocksPerSm = 16;")],
}


def make_args(pattern: str, b: int, c: int, h: int, w: int, dtype, gen, device):
    """``mxdet::frozen_bn_act``'s arguments for ``pattern`` at (b, c, h, w):
    maps of N(0, 1) in channels_last, FrozenBN-like scales of both signs and
    biases, drawn on ``device`` from ``gen`` (a generator of that device)."""
    import torch

    def nhwc():
        return torch.randn((b, h, w, c), generator=gen, device=device).to(dtype).permute(
            0, 3, 1, 2)

    def chans(scale=1.0):
        return (torch.randn((c,), generator=gen, device=device) * scale).to(dtype)

    x = nhwc()
    if pattern == "a":
        return (x, chans(), chans(), None, None, None)
    if pattern == "b_identity":
        return (x, chans(0.2), chans(), nhwc(), None, None)
    return (x, chans(0.2), chans(), nhwc(), chans(), chans())


def kernel_fwd(args, y):
    """A function that launches the forward kernel of the loaded library on
    ``args`` (``make_args``'s, bf16) into ``y``, the pointers bound once."""
    import torch

    x, s, b, r, rs, rb = args
    mode = 0 if r is None else 1 if rs is None else 2
    r = x if r is None else r
    rs, rb = (s, b) if rs is None else (rs, rb)
    lib = build.load_library()
    call = (x.data_ptr(), s.data_ptr(), b.data_ptr(), r.data_ptr(), rs.data_ptr(),
            rb.data_ptr(), y.data_ptr(), x.numel(), x.shape[1], int(x.dtype == torch.bfloat16),
            mode, torch.cuda.current_stream().cuda_stream)
    return lambda: build.check(lib.mxdet_norm_act_fwd(*call), "mxdet_norm_act_fwd")


def kernel_bwd(args, g, y, dx, dr):
    """As ``kernel_fwd``, the backward kernel: g and the forward's output y
    into dx and dr."""
    import torch

    _, s, _, r, rs, _ = args
    mode = 0 if r is None else 1 if rs is None else 2
    rs = s if rs is None else rs
    lib = build.load_library()
    call = (g.data_ptr(), y.data_ptr(), s.data_ptr(), rs.data_ptr(), dx.data_ptr(),
            dr.data_ptr(), g.numel(), g.shape[1], int(g.dtype == torch.bfloat16), mode,
            torch.cuda.current_stream().cuda_stream)
    return lambda: build.check(lib.mxdet_norm_act_bwd(*call), "mxdet_norm_act_bwd")


def bytes_moved(pattern: str, n: int, itemsize: int, backward: bool = False) -> int:
    """The bytes the pass must move (each map read once and written once):
    forward x (and r) in, y out; backward g and y in, dx (and dr) out."""
    maps = (3 if backward else 2) + (0 if pattern == "a" else 1)
    return maps * n * itemsize


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None, help="the variants to time")
    args = ap.parse_args(argv)
    names = [n for n in VARIANTS if args.only is None or n in args.only or n == "base"]
    libs = build_variants(
        names, lambda name, src, root: copy_with_edits(src, root, SOURCE, VARIANTS[name]),
        "norm_act_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for pattern, c, h, w, n50, _ in SHAPES:
        fa = make_args(pattern, 32, c, h, w, torch.bfloat16, gen, "cuda")
        ba = make_args(pattern, 8, c, h, w, torch.bfloat16, gen, "cuda")
        g = torch.randn(ba[0].shape, generator=gen, device="cuda").to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cases.append((pattern, c, h, w, n50, fa, ba, g))
    bound = sum(n50 * bytes_moved(p, fa[0].numel(), 2) for p, _, _, _, n50, fa, _, _ in cases)
    bwd_bound = sum(n50 * bytes_moved(p, ba[0].numel(), 2, True)
                    for p, _, _, _, n50, _, ba, _ in cases)
    print(f"{torch.cuda.get_device_name(0)}: bounds {bound / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"forward (R50, batch 32), {bwd_bound / HBM_BYTES_PER_S * 1e3:.3f} ms backward "
          "(batch 8)", flush=True)
    ref = None
    for rnd in range(2):
        for name in names:
            use_variant(libs[name])
            fwd = bwd = 0.0
            outs = []
            for pattern, c, h, w, n50, fa, ba, g in cases:
                y = torch.zeros_like(fa[0])
                fwd += n50 * time_ms(kernel_fwd(fa, y))
                yb, dx, dr = (torch.zeros_like(ba[0]) for _ in range(3))
                kernel_fwd(ba, yb)()
                bwd += n50 * time_ms(kernel_bwd(ba, g, yb, dx, dr))
                outs.append([t.view(torch.int16).sum(dtype=torch.int64).item()
                             for t in (y, yb, dx, dr)])
            if ref is None:
                ref = outs
            same = outs == ref
            pct = bound / HBM_BYTES_PER_S * 1e5 / fwd
            bwd_pct = bwd_bound / HBM_BYTES_PER_S * 1e5 / bwd
            print(f"round {rnd} {name}: forward {fwd:.3f} ms ({pct:.1f} % of the byte "
                  f"roofline), backward {bwd:.3f} ms ({bwd_pct:.1f} %); outputs "
                  f"{'the same' if same else 'DIFFER'}", flush=True)
    use_variant((build.CSRC_DIR, build.BUILD_DIR))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
