"""Build and load the port's CUDA kernels (``csrc/*.cu``) for Hopper.

``nvcc`` compiles every source of ``csrc/`` into an object, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, ``_build/libmxdet_kernels_<hash>.so`` inside the
package, at first use; the hash covers the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the library. The library is loaded
with ``ctypes``; nothing includes PyTorch's headers, which keeps a build to
seconds. Nothing here runs at import time.

Run ``python -m mxdetection_tpu_torch.ops.cuda.build`` to build and print
nvcc's register and shared-memory report (``-Xptxas -v``).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class LaunchCount:
    """Number of kernel launches a wrapper made; ``chip_smoke.py`` resets it
    before the main path and reads it after, to show the path used the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def add(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    nvcc = cand if os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME)")
    return nvcc


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libmxdet_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float, str]:
    """Compile ``csrc/*.cu`` unless the library for this source hash exists.

    Returns (library path, build seconds (0.0 when reused), nvcc's report).
    """
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    report = []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        report.append(out)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, time.perf_counter() - t0, "".join(report) + res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.mxdet_roi_align_fwd.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, i, p]
    lib.mxdet_roi_align_bwd.argtypes = [p, p, p, p, i, p, p, p, p, i, i, i, i, i, i, p]
    lib.mxdet_f32_to_bf16.argtypes = [p, p, ll, p]
    lib.mxdet_nms_mask_sorted.argtypes = [p, p, i, i, f, p, p, p]
    lib.mxdet_pairwise_iou.argtypes = [p, ll, p, i, i, i, p, p]
    for fn in (lib.mxdet_roi_align_fwd, lib.mxdet_roi_align_bwd, lib.mxdet_f32_to_bf16,
               lib.mxdet_nms_mask_sorted, lib.mxdet_pairwise_iou):
        fn.restype = i
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


if __name__ == "__main__":
    lib_path, seconds, report = build()
    print(f"{lib_path} built in {seconds:.1f} s")
    print(report)
