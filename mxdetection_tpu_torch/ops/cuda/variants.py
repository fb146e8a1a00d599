"""What ``k5_variants`` and ``k7_variants`` share: the DCN layer shapes they
time, edited copies of ``csrc/`` built side by side, switching ``build``
between them, and a CUDA-event timer. Runs only on a machine with a CUDA
card; importing it needs none."""

from __future__ import annotations

import os
import shutil

from . import build

LAYERS = [  # (input H, W, channels, stride, layers of this shape a batch); Cin = Cout
    (208, 336, 128, 2, 1), (104, 168, 128, 1, 3), (104, 168, 256, 2, 1),
    (52, 84, 256, 1, 22), (52, 84, 512, 2, 1), (26, 42, 512, 1, 2),
]
REPS = 20


def copy_with_edits(src_dir: str, root: str, filename: str, edits: list) -> str:
    """Copy ``src_dir`` (a csrc/) to ``root/csrc`` with ``edits`` (pairs of
    old, new text, each old text occurring exactly once) applied to
    ``filename``; -> the copy's csrc directory."""
    shutil.rmtree(root, ignore_errors=True)
    csrc = os.path.join(root, "csrc")
    shutil.copytree(src_dir, csrc)
    path = os.path.join(csrc, filename)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{filename}: {old!r} does not occur exactly once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return csrc


def build_variants(variants: dict, make, subdir: str) -> dict:
    """Build each variant (``make(name, src_dir, root)`` makes its csrc)
    under ``_build/<subdir>/<name>/``; -> {name: (csrc dir, build dir)}.
    Leaves ``build`` pointing at the package's own sources."""
    src_dir, build_dir = build.CSRC_DIR, build.BUILD_DIR
    libs = {}
    try:
        for name in variants:
            root = os.path.join(build_dir, subdir, name)
            build.CSRC_DIR = make(name, src_dir, root)
            build.BUILD_DIR = os.path.join(root, "_build")
            _, secs, report = build.build()
            regs = [ln.split(":", 1)[1].strip() for ln in report.splitlines()
                    if "Used" in ln and "registers" in ln]
            print(f"built {name} in {secs:.1f} s: {regs}", flush=True)
            libs[name] = (build.CSRC_DIR, build.BUILD_DIR)
    finally:
        build.CSRC_DIR, build.BUILD_DIR = src_dir, build_dir
    return libs


def use_variant(dirs: tuple) -> None:
    """Point ``build`` at a (csrc dir, build dir) pair: a variant's, or the
    package's own."""
    build.CSRC_DIR, build.BUILD_DIR = dirs
    build.load_library.cache_clear()


def time_ms(fn, reps: int = REPS) -> float:
    """CUDA-event mean of ``fn`` over ``reps`` calls after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
