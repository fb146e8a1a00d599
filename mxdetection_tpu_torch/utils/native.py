"""Build and load the repository's host C++ (``native/*.cpp``) for the port.

The COCO evaluation's RLE codec (``native/rle.cpp``) and its greedy matcher
(``native/coco_match.cpp``) are plain C functions. ``build`` compiles a
source with ``native/Makefile``'s flags into ``_build/lib<name>_<hash>.so``
inside the package (the hash covers the source and the flags; an unchanged
source reuses the library) and never writes into ``native/``. ``load``
returns the ``ctypes`` handle and raises when the build fails: the callers
decide whether the numpy implementation may take over, and say so.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXXFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]


def library_path(name: str) -> str:
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        h = hashlib.sha256(" ".join(CXXFLAGS).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless its library exists; returns its path."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp,
           os.path.join(NATIVE_DIR, f"{name}.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``native/<name>.cpp`` once per process."""
    return ctypes.CDLL(build(name))
