"""ctypes binding of the C++ RLE codec (``native/rle.cpp``) — port of
``mxdetection_tpu.eval.rle_native``.

The library is built into the package's ``_build/`` on first use
(``utils/native.py``). Where it cannot be built, ``available()`` is false
and the callers take the numpy codec of ``rle.py`` (the same results);
``implementation()`` names the codec in use and the first call logs it, so
a run that needs the native codec can check it ran.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import subprocess

import numpy as np

from ..utils import native

log = logging.getLogger(__name__)


@functools.lru_cache(maxsize=None)
def _load():
    try:
        lib = native.load("rle")
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        log.warning("native RLE codec unavailable, the numpy codec runs: %s", err)
        return None
    ip = ctypes.POINTER(ctypes.c_int)
    up = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [up, ctypes.c_int, ctypes.c_int, ip, ctypes.c_int]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [ip, ctypes.c_int, ctypes.c_int, ctypes.c_int, up]
    lib.rle_area.restype = ctypes.c_long
    lib.rle_area.argtypes = [ip, ctypes.c_int]
    lib.rle_iou.restype = ctypes.c_double
    lib.rle_iou.argtypes = [ip, ctypes.c_int, ip, ctypes.c_int, ctypes.c_int]
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = [ip, ip, ctypes.c_int, ip, ip, ctypes.c_int, up, dp]
    log.info("native RLE codec: %s", lib._name)
    return lib


def available() -> bool:
    return _load() is not None


def implementation() -> str:
    """"native" (``native/rle.cpp``) or "numpy" (``rle.py``)."""
    return "native" if available() else "numpy"


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native RLE codec is not built (see the log)")
    return lib


def _as_int_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def encode(mask: np.ndarray) -> dict:
    lib = _lib()
    h, w = mask.shape
    flat = np.ascontiguousarray(np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F"))
    buf = np.zeros(h * w + 2, np.int32)
    n = lib.rle_encode(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       h, w, _as_int_ptr(buf), len(buf))
    if n <= 0:
        raise RuntimeError(f"rle_encode returned {n} for a {h}x{w} mask")
    return {"size": [int(h), int(w)], "counts": buf[:n].tolist()}


def decode(rle: dict) -> np.ndarray:
    lib = _lib()
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int32)
    out = np.zeros(h * w, np.uint8)
    lib.rle_decode(_as_int_ptr(counts), len(counts), h, w,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.reshape((h, w), order="F")


def area(rle: dict) -> int:
    counts = np.asarray(rle["counts"], np.int32)
    return int(_lib().rle_area(_as_int_ptr(counts), len(counts)))


def iou(dt: dict, gt: dict, iscrowd: bool = False) -> float:
    d = np.asarray(dt["counts"], np.int32)
    g = np.asarray(gt["counts"], np.int32)
    return float(_lib().rle_iou(_as_int_ptr(d), len(d), _as_int_ptr(g), len(g), int(iscrowd)))


def iou_matrix(dts: list[dict], gts: list[dict], iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU matrix by one native call; crowd gts give IoF."""
    lib = _lib()
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)))

    def pack(rles):
        runs = np.concatenate([np.asarray(r["counts"], np.int32) for r in rles])
        off = np.zeros(len(rles) + 1, np.int32)
        np.cumsum([len(r["counts"]) for r in rles], out=off[1:])
        return np.ascontiguousarray(runs), off

    druns, doff = pack(dts)
    gruns, goff = pack(gts)
    crowd = np.ascontiguousarray(np.asarray(iscrowd, np.uint8))
    out = np.zeros((len(dts), len(gts)), np.float64)
    lib.rle_iou_matrix(
        _as_int_ptr(druns), _as_int_ptr(doff), len(dts),
        _as_int_ptr(gruns), _as_int_ptr(goff), len(gts),
        crowd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
