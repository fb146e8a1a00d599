"""Wrappers of the CUDA deformable-conv kernels (``csrc/deform_conv.cu``,
``csrc/deform_conv_bwd.cu``).

Counterparts of ``mxdetection_tpu/ops/pallas/dcn.py``:

- ``deform_conv2d_cuda``: ``_kernel`` (K5, stride 1) and ``_kernel_s2``
  (K5b, stride 2), the forward;
- ``deform_wgrad_doffsets_cuda``: ``_patches_kernel`` (K6) and
  ``_patches_kernel_s2`` (K6b) fused with the product dW = patches^T g and
  the offset gradient's reduction over channels that followed them: the
  patch values go from the gather straight into a tensor-core product in
  shared memory; ``wgmma_g_tiles`` is the plain version of g's layout for
  it, ``wgrad_config`` and ``wgrad_split`` the plain model of its
  partition;
- ``deform_col2im_cuda``: ``_dx_kernel`` (K7) and ``_dx_kernel_s2`` (K7b),
  dx as the transpose of the sampling, summed per output tile in a
  shared-memory window; ``col2im_window_split`` is the plain model of that
  partition.

Reached from ``ops/dcn.py`` for CUDA tensors, through the operator
``mxdet::deform_conv2d`` (``ops/library.py``) and its backward
``deform_conv2d_backward``; the plain versions are ``ops/dcn.py::deform_conv2d``, ``deform_wgrad_doffsets`` and
``deform_col2im``. One kernel serves both strides; each stride has its own
launch counter.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re

import torch

from . import build
from .build import LaunchCount, check, load_library
from ..dcn import _bilinear_weights, _corners, clip_offset_grad, offset_grad_terms

launch_count = LaunchCount("deform_conv")        # K5, stride 1
s2_launch_count = LaunchCount("deform_conv_s2")  # K5b, stride 2
wgrad_launch_count = LaunchCount("deform_wgrad_doffsets")        # K6
wgrad_s2_launch_count = LaunchCount("deform_wgrad_doffsets_s2")  # K6b
col2im_launch_count = LaunchCount("deform_col2im")                   # K7
col2im_s2_launch_count = LaunchCount("deform_col2im_s2")             # K7b

_DTYPES = (torch.float32, torch.bfloat16)
TILE_K = 64      # the forward walks Cin in chunks of TILE_K (one 128-byte bf16 row)
F32_TILE_N = 64  # the f32 forward's output-channel tile
VEC = 4          # K7 walks channels in vectors of VEC
MAX_X_ELEMENTS = 2 ** 31 - 1  # the bf16 K5 and K6 keep corner offsets in 32 bits


def bf16_tile_n(cout: int) -> int | None:
    """Output channels of one block of the bf16 forward (one wgmma tile):
    all of Cout = 128, or 256 when Cout is a multiple of 256; None for a
    Cout it does not take."""
    if cout == 128:
        return 128
    return 256 if cout > 0 and cout % 256 == 0 else None


def wgmma_weight_tiles(weight: torch.Tensor, tile_n: int) -> torch.Tensor:
    """The bf16 forward's layout of W = weight.reshape(9 * Cin, Cout), plain
    version of ``wgmma_weight_tiles_cuda``: K-major tiles of (tile_n output
    channels x 64 rows of K), in the 128-byte swizzle that the kernel's wgmma
    descriptors read, so one contiguous bulk copy fills a stage. Shape
    (Cout / tile_n, 9 * Cin / 64, tile_n, 64); element (j, kc, n, 8 * s + e)
    is W[64 * kc + 8 * (s ^ (n % 8)) + e, tile_n * j + n]."""
    cin, cout = weight.shape[2], weight.shape[3]
    k = 9 * cin
    wt = weight.reshape(k, cout).t().reshape(cout // tile_n, tile_n, k // TILE_K, 8, 8)
    wt = wt.permute(0, 2, 1, 3, 4)  # (j, kc, n, 16-byte group, e)
    n = torch.arange(tile_n, device=weight.device)
    group = torch.arange(8, device=weight.device)[None, :] ^ (n[:, None] % 8)
    return wt[:, :, n[:, None], group].reshape(cout // tile_n, k // TILE_K, tile_n, TILE_K)


def _check_geometry(what: str, x_shape, offsets: torch.Tensor, stride: int,
                    dilation: int) -> tuple:
    """-> (B, H, W, C, Ho, Wo) after checking the offsets against x's shape."""
    if offsets.dtype != torch.float32:
        raise TypeError(f"{what}: offsets must be float32, got {offsets.dtype}")
    if len(x_shape) != 4:
        raise ValueError(f"{what}: x shape {tuple(x_shape)}, expected (B, H, W, C)")
    b, h, w, c = x_shape
    if stride not in (1, 2) or dilation < 1:
        raise ValueError(f"{what}: stride {stride} (1 or 2), dilation {dilation}")
    ho, wo = -(-h // stride), -(-w // stride)
    if offsets.shape != (b, ho, wo, 18):
        raise ValueError(f"{what}: offsets {tuple(offsets.shape)}, expected {(b, ho, wo, 18)}")
    if not offsets.is_contiguous():
        raise ValueError(f"{what}: offsets must be contiguous")
    return b, h, w, c, ho, wo


def _check_device(what: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors]}; expected "
                         "one CUDA device")
    return dev


def _radius(radius: float | None) -> float:
    return -1.0 if radius is None else float(radius)


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call the library's C entry point ``name`` on ``dev``'s current stream
    and raise if the launch failed."""
    lib = load_library()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)


def wgmma_weight_tiles_cuda(weight: torch.Tensor) -> torch.Tensor:
    """``wgmma_weight_tiles(weight, bf16_tile_n(Cout))`` on the card, by the
    layout kernel of ``csrc/deform_conv.cu``: weight (3, 3, Cin, Cout) bf16
    HWIO on a CUDA device, Cin a multiple of 64."""
    what = "wgmma_weight_tiles_cuda"
    if weight.dtype != torch.bfloat16 or weight.dim() != 4 or weight.shape[:2] != (3, 3):
        raise ValueError(f"{what}: weight {weight.dtype} {tuple(weight.shape)}; expected bf16 "
                         "(3, 3, Cin, Cout)")
    cin, cout = weight.shape[2], weight.shape[3]
    tile_n = bf16_tile_n(cout)
    if cin % TILE_K or cin == 0 or tile_n is None:
        raise ValueError(f"{what}: Cin={cin}, Cout={cout}; Cin a multiple of {TILE_K}, Cout 128 "
                         "or a multiple of 256")
    dev = _check_device(what, weight)
    weight = weight.contiguous()
    tiles = torch.empty((cout // tile_n, 9 * cin // TILE_K, tile_n, TILE_K), dtype=weight.dtype,
                        device=dev)
    _launch("mxdet_deform_conv_weight_tiles", dev, weight.data_ptr(), tiles.data_ptr(), cin, cout)
    return tiles


def deform_conv2d_cuda(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, *,
                       stride: int = 1, dilation: int = 1,
                       radius: float | None = None) -> torch.Tensor:
    """x (B, H, W, Cin) contiguous, f32 or bf16; offsets (B, Ho, Wo, 18) f32,
    Ho = ceil(H / stride); weight (3, 3, Cin, Cout) HWIO in x's dtype ->
    (B, Ho, Wo, Cout) in x's dtype. ``radius`` clamps the offsets. Cin is a
    multiple of 64; Cout a multiple of 64 in f32, and 128 or a multiple of
    256 in bf16, whose kernel also takes x of at most 2^31 - 1 elements.
    For bf16 the entry point first lays the weight out as
    ``wgmma_weight_tiles_cuda`` does, on every call (1.2 MB at
    Cin = Cout = 256)."""
    what = "deform_conv2d_cuda"
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} and weight {weight.dtype} must be one dtype of "
                        f"{_DTYPES}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[:2] != (3, 3):
        raise ValueError(f"{what}: x {tuple(x.shape)}, weight {tuple(weight.shape)}; expected "
                         "(B, H, W, Cin), (3, 3, Cin, Cout)")
    b, h, w, cin, ho, wo = _check_geometry(what, x.shape, offsets, stride, dilation)
    cout = weight.shape[3]
    bf16 = x.dtype == torch.bfloat16
    tile_n = bf16_tile_n(cout) if bf16 else (F32_TILE_N if cout % F32_TILE_N == 0 else None)
    if weight.shape[2] != cin or cin % TILE_K or cin == 0 or tile_n is None:
        raise ValueError(f"{what}: Cin={cin}, Cout={cout}; the weight must take x's channels, "
                         f"Cin a multiple of {TILE_K}, Cout "
                         + ("128 or a multiple of 256 (bf16)" if bf16 else
                            f"a multiple of {F32_TILE_N} (f32)"))
    if bf16 and x.numel() > MAX_X_ELEMENTS:
        raise ValueError(f"{what}: x has {x.numel()} elements; the bf16 kernel takes at most "
                         f"{MAX_X_ELEMENTS}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous NHWC, 16-byte aligned")
    dev = _check_device(what, x, offsets, weight)
    wmat = weight.reshape(9 * cin, cout).contiguous()
    if wmat.data_ptr() % 16:
        wmat = wmat.clone()
    # bf16: scratch for the weight's tiles, which the entry point lays out
    # (as wgmma_weight_tiles_cuda) before the kernel reads them
    tiles = torch.empty_like(wmat) if bf16 else None
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=dev)
    _launch("mxdet_deform_conv_fwd", dev, x.data_ptr(), offsets.data_ptr(), wmat.data_ptr(),
            tiles.data_ptr() if bf16 else None, out.data_ptr(), b, h, w, cin, ho, wo, cout,
            stride, dilation, _radius(radius), int(bf16))
    (launch_count if stride == 1 else s2_launch_count).add()
    return out


def _check_dpatch(what: str, dpatch: torch.Tensor, b: int, ho: int, wo: int, c: int) -> None:
    if dpatch.dtype not in _DTYPES:
        raise TypeError(f"{what}: dpatch dtype {dpatch.dtype} not in {_DTYPES}")
    if dpatch.shape != (b, ho, wo, 9 * c):
        raise ValueError(f"{what}: dpatch {tuple(dpatch.shape)}, expected {(b, ho, wo, 9 * c)}")
    if c % VEC:
        raise ValueError(f"{what}: C={c} must be a multiple of {VEC}")
    if not dpatch.is_contiguous() or dpatch.data_ptr() % 16:
        raise ValueError(f"{what}: dpatch must be contiguous, 16-byte aligned")


def deform_wgrad_doffsets_cuda(x: torch.Tensor, offsets: torch.Tensor, dpatch: torch.Tensor,
                               g: torch.Tensor, *, stride: int = 1, dilation: int = 1,
                               radius: float | None = None) -> tuple:
    """K6 (stride 1) / K6b (stride 2), the fused weight gradient: x (B, H, W,
    C) contiguous, f32 or bf16, C a multiple of 64; offsets (B, Ho, Wo, 18)
    f32; dpatch (B, Ho, Wo, 9C) and g (B * Ho * Wo, Cout) in x's dtype, Cout
    128 or a multiple of 256 (bf16), a multiple of 64 (f32) -> (dW (9C, Cout)
    f32, doffsets (B, Ho, Wo, 18) f32). The slices of M and the scratch
    follow what the built kernel reports (``wgrad_layout_cuda``)."""
    what = "deform_wgrad_doffsets_cuda"
    if x.dtype not in _DTYPES or dpatch.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} and dpatch {dpatch.dtype} must be one dtype of "
                        f"{_DTYPES}")
    if g.dtype != x.dtype:
        raise TypeError(f"{what}: g {g.dtype} must have x's dtype {x.dtype}")
    b, h, w, c, ho, wo = _check_geometry(what, x.shape, offsets, stride, dilation)
    _check_dpatch(what, dpatch, b, ho, wo, c)
    if c % TILE_K:
        raise ValueError(f"{what}: C={c} must be a multiple of {TILE_K}")
    m = b * ho * wo
    if g.dim() != 2 or g.shape[0] != m:
        raise ValueError(f"{what}: g {tuple(g.shape)}, expected (B*Ho*Wo, Cout) = ({m}, Cout)")
    cout = g.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if not (bf16_tile_n(cout) is not None if bf16 else cout > 0 and cout % F32_TILE_N == 0):
        raise ValueError(f"{what}: Cout={cout}; " + ("128 or a multiple of 256 (bf16)" if bf16
                                                     else f"a multiple of {F32_TILE_N} (f32)"))
    if bf16 and x.numel() > MAX_X_ELEMENTS:
        raise ValueError(f"{what}: x has {x.numel()} elements; the bf16 kernel takes at most "
                         f"{MAX_X_ELEMENTS}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(f"{what}: g must be contiguous, 16-byte aligned")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous NHWC, 16-byte aligned")
    dev = _check_device(what, x, offsets, dpatch, g)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = wgrad_layout_cuda(c, cout, m, sms, bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    dw = torch.empty((9 * c, cout), **f32)
    doff = torch.empty((b, ho, wo, 18), **f32)
    part = torch.empty((lay["slices"], 9 * c, cout), **f32) if lay["slices"] > 1 else None
    doff_ws = torch.empty((c // TILE_K, m, 18), **f32)
    gtiles = (torch.empty((lay["chunks"] * lay["chunk"], cout), dtype=x.dtype, device=dev)
              if bf16 else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch("mxdet_deform_wgrad_doffsets", dev, x.data_ptr(), offsets.data_ptr(),
            dpatch.data_ptr(), g.data_ptr(), ptr(gtiles), ptr(part), dw.data_ptr(),
            doff_ws.data_ptr(), doff.data_ptr(), b, h, w, c, ho, wo, cout, stride, dilation,
            _radius(radius), sms, int(bf16))
    (wgrad_launch_count if stride == 1 else wgrad_s2_launch_count).add()
    return dw, doff


def deform_col2im_cuda(dpatch: torch.Tensor, offsets: torch.Tensor, x_shape, *,
                       stride: int = 1, dilation: int = 1,
                       radius: float | None = None) -> torch.Tensor:
    """K7 (stride 1) / K7b (stride 2): dpatch (B, Ho, Wo, 9C) contiguous, f32
    or bf16; offsets (B, Ho, Wo, 18) f32 -> dx (B, H, W, C) f32 for x of
    ``x_shape`` (H, W at most 16384), summed per tile in shared memory
    (``col2im_window_split``) and added with f32 atomics into a zeroed
    buffer; the caller casts."""
    what = "deform_col2im_cuda"
    b, h, w, c, ho, wo = _check_geometry(what, tuple(x_shape), offsets, stride, dilation)
    _check_dpatch(what, dpatch, b, ho, wo, c)
    dev = _check_device(what, dpatch, offsets)
    dx = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    _launch("mxdet_deform_col2im", dev, dpatch.data_ptr(), offsets.data_ptr(), dx.data_ptr(),
            b, h, w, c, ho, wo, stride, dilation, _radius(radius),
            int(dpatch.dtype == torch.bfloat16))
    (col2im_launch_count if stride == 1 else col2im_s2_launch_count).add()
    return dx


# ---------------------------------------------------------------- K7's window
# The kernel's constants live in its source alone; the plain model reads them
# from there (``col2im_config``). The window it derives from them is held, on
# the card, against what the built kernel reports (``mxdet_deform_col2im_layout``).
COL2IM_SOURCE = "deform_conv_bwd.cu"


@functools.lru_cache(maxsize=None)
def _col2im_constants(csrc_dir: str) -> dict:
    with open(os.path.join(csrc_dir, COL2IM_SOURCE)) as f:
        text = f.read()
    reach = re.search(r"constexpr int kReach = (\d+);", text)
    lane = re.search(r"constexpr int kCV = (\d+);", text)
    tiles = {int(s): (int(th), int(tw)) for s, th, tw in re.findall(
        r"struct Col2imTile<(\d)> \{ static constexpr int kTH = (\d+), kTW = (\d+); \};", text)}
    if reach is None or lane is None or sorted(tiles) != [1, 2]:
        raise RuntimeError(f"{COL2IM_SOURCE}: kReach, kCV or Col2imTile<1|2> not found")
    return {"reach": int(reach.group(1)), "chunk": 32 * int(lane.group(1)), **tiles}


def col2im_config(stride: int, csrc_dir: str | None = None) -> dict:
    """K7's partition at ``stride`` from the kernel source's constants
    (``csrc_dir``, the package's by default): ``tile`` (rows, cols of output
    pixels a block owns), ``chunk`` (channels it sums at once), ``reach``,
    and the window: ``origin`` (its first input row is the tile's first
    output row * stride - origin; columns alike) and ``window`` (its rows,
    cols: the tile's stride (rows - 1) + 1 base rows, the taps' +-1, the
    reach on both sides and the far corner y0 + 1). So a corner lands in the
    window for offsets from -reach to reach + 1 cells."""
    const = _col2im_constants(csrc_dir or build.CSRC_DIR)
    tile, reach = const[stride], const["reach"]
    return {"tile": tile, "chunk": const["chunk"], "reach": reach, "origin": reach + 1,
            "window": tuple(stride * (n - 1) + 2 * reach + 4 for n in tile)}


def col2im_layout_cuda(stride: int, is_bf16: bool) -> dict:
    """What the built kernel reports at ``stride`` for bf16 or f32 dpatch, in
    ``col2im_config``'s keys (no ``reach``), plus ``smem`` (dynamic shared
    memory a block, bytes). Builds the library on first use; launches
    nothing."""
    out = (ctypes.c_int * 7)()
    check(load_library().mxdet_deform_col2im_layout(stride, int(is_bf16), out),
          "mxdet_deform_col2im_layout")
    th, tw, wr, wc, origin, chunk, smem = out
    return {"tile": (th, tw), "chunk": chunk, "origin": origin, "window": (wr, wc), "smem": smem}


def col2im_window_split(dpatch: torch.Tensor, offsets: torch.Tensor, x_shape, *,
                        stride: int = 1, dilation: int = 1, radius: float | None = None,
                        tile: tuple | None = None, reach: int | None = None) -> tuple:
    """Plain model of K7's partition of ``ops/dcn.py::deform_col2im``: every
    term dpatch * w of a corner inside the map with a nonzero weight goes
    either into the window of its output pixel's tile (output rows
    [ti * th, ti * th + th), the window's first input row
    ti * th * stride - reach - 1, ``col2im_config``'s rows; columns alike)
    or, outside it, straight into dx (a spill). ``tile`` and ``reach``
    default to the kernel's. Returns (in-window sum, spilled sum), each
    (B, H, W, C) float32, and the number of spilled corners; the two sums add
    up to ``deform_col2im``."""
    conf = col2im_config(stride)
    th, tw = tile or conf["tile"]
    reach = conf["reach"] if reach is None else reach
    wr, wc = (stride * (n - 1) + 2 * reach + 4 for n in (th, tw))
    b, h, w, c = x_shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    ly, lx, corners = _corners((b, h, w), offsets, kernel=3, stride=stride, dilation=dilation,
                               radius=radius)
    dev = offsets.device
    oy = ((torch.arange(ho, device=dev) // th) * th * stride - reach - 1).view(1, ho, 1, 1, 1)
    ox = ((torch.arange(wo, device=dev) // tw) * tw * stride - reach - 1).view(1, 1, wo, 1, 1)
    dp = dpatch.float().reshape(b, ho, wo, 3, 3, c)
    inside = torch.zeros((b * h * w, c), dtype=torch.float32, device=dev)
    spilled = torch.zeros_like(inside)
    n_spilled = 0
    for (rows, inb), wgt in zip(corners, _bilinear_weights(ly, lx)):
        wt = wgt * inb
        y, x = (rows % (h * w)) // w, rows % w  # the corner's cell where its weight is nonzero
        in_win = (y - oy >= 0) & (y - oy < wr) & (x - ox >= 0) & (x - ox < wc)
        spill = (wt != 0) & ~in_win
        n_spilled += int(spill.sum())
        flat = rows.reshape(-1)
        inside.index_add_(0, flat, (dp * (wt * in_win)[..., None]).reshape(-1, c))
        spilled.index_add_(0, flat, (dp * (wt * ~in_win)[..., None]).reshape(-1, c))
    return inside.reshape(b, h, w, c), spilled.reshape(b, h, w, c), n_spilled


# ---------------------------------------------------------------- K6's partition
# As for K7, the kernel's constants live in its source alone; the plain model
# reads them from there (``wgrad_config``) and is held, on the card, against
# what the built kernel reports (``mxdet_deform_wgrad_layout``).
WGRAD_SOURCE = "deform_conv_bwd.cu"


@functools.lru_cache(maxsize=None)
def _wgrad_constants(csrc_dir: str) -> dict:
    with open(os.path.join(csrc_dir, WGRAD_SOURCE)) as f:
        text = f.read()
    found = {key: re.search(rf"constexpr int {name} = (\d+);", text) for key, name in (
        ("rows", "kWgRows"), ("chunk", "kWgPix"), ("min_chunks", "kWgMinChunks"),
        ("max_slices", "kWgMaxSlices"))}
    f32_tile = re.search(r"namespace wgf32 \{\s*constexpr int kBN = (\d+);", text)
    if f32_tile is None or any(v is None for v in found.values()):
        raise RuntimeError(f"{WGRAD_SOURCE}: kWgRows, kWgPix, kWgMinChunks, kWgMaxSlices or "
                           "wgf32::kBN not found")
    return {**{k: int(v.group(1)) for k, v in found.items()}, "f32_tile_n": int(f32_tile.group(1))}


def wgrad_slices(tiles: int, chunks: int, sms: int, min_chunks: int, max_slices: int) -> int:
    """The kernel's slices of M (``wgrad_slices`` in its source): of S = 1 ..
    min(max_slices, chunks // min_chunks), the one with the least
    ceil(tiles * S / sms) / S (the grid's waves of one block an SM per
    slice of the work), the fewest among equals."""
    most = max(1, min(max_slices, chunks // min_chunks))
    best, best_waves = 1, -(-tiles // sms)
    for s in range(2, most + 1):
        waves = -(-tiles * s // sms)
        if waves * best < best_waves * s:
            best, best_waves = s, waves
    return best


def wgrad_config(c: int, cout: int, m: int, *, sms: int = 132, bf16: bool = True,
                 csrc_dir: str | None = None) -> dict:
    """K6's partition of a layer with C input and Cout output channels and
    M output pixels, from the kernel source's constants (``csrc_dir``, the
    package's by default): ``rows`` (dW rows a block: one tap's ``rows``
    channels), ``tile_n`` (output channels a block), ``chunk`` (pixels a
    step of its walk over M), ``chunks`` (of M, the last one ragged) and
    ``slices`` (of the chunks, one a block, for ``sms`` SMs)."""
    const = _wgrad_constants(csrc_dir or build.CSRC_DIR)
    tile_n = bf16_tile_n(cout) if bf16 else const["f32_tile_n"]
    chunks = -(-m // const["chunk"])
    tiles = 9 * c // const["rows"] * (cout // tile_n)
    return {"rows": const["rows"], "tile_n": tile_n, "chunk": const["chunk"], "chunks": chunks,
            "slices": wgrad_slices(tiles, max(chunks, 1), sms, const["min_chunks"],
                                   const["max_slices"])}


def wgrad_layout_cuda(c: int, cout: int, m: int, sms: int, is_bf16: bool) -> dict:
    """What the built kernel decides for this shape, in ``wgrad_config``'s
    keys plus ``smem`` (dynamic shared memory a block, bytes; 0 for f32).
    Builds the library on first use; launches nothing."""
    out = (ctypes.c_int * 6)()
    check(load_library().mxdet_deform_wgrad_layout(c, cout, m, sms, int(is_bf16), out),
          "mxdet_deform_wgrad_layout")
    rows, tile_n, chunk, slices, chunks, smem = out
    return {"rows": rows, "tile_n": tile_n, "chunk": chunk, "chunks": chunks, "slices": slices,
            "smem": smem}


def wgmma_g_tiles(g: torch.Tensor, tile_n: int, chunk: int) -> torch.Tensor:
    """The bf16 kernel's layout of g (M, Cout), its product's B operand read
    MN-major: for each column tile j and chunk kc of ``chunk`` pixels
    (``wgrad_config``'s), the tile_n / 64 blocks of (pixel k, 64 output
    channels) in the 128-byte swizzle. Shape (Cout / tile_n, chunks, tile_n /
    64, chunk, 64); element (j, kc, a, k, 8 * s + e) is g[chunk * kc + k,
    tile_n * j + 64 * a + 8 * (s ^ (k % 8)) + e], zero for pixels past M.
    Plain version of the pass ``g_tiles_kernel`` that the entry point runs
    before the kernel."""
    m, cout = g.shape
    chunks = -(-m // chunk)
    padded = torch.zeros((chunks * chunk, cout), dtype=g.dtype, device=g.device)
    padded[:m] = g
    t = padded.reshape(chunks, chunk, cout // tile_n, tile_n // 64, 8, 8)
    t = t.permute(2, 0, 3, 1, 4, 5)  # (j, kc, a, k, 16-byte group, e)
    k = torch.arange(chunk, device=g.device)
    group = torch.arange(8, device=g.device)[None, :] ^ (k[:, None] % 8)
    return t[:, :, :, k[:, None], group].reshape(cout // tile_n, chunks, tile_n // 64, chunk,
                                                 64).contiguous()


def wgrad_split(x: torch.Tensor, offsets: torch.Tensor, dpatch: torch.Tensor, g: torch.Tensor,
                *, stride: int = 1, dilation: int = 1, radius: float | None = None,
                sms: int = 132, slices: int | None = None) -> tuple:
    """Plain model of K6's partition of ``ops/dcn.py::deform_wgrad_doffsets``:

    - dW: M is cut into chunks of ``chunk`` pixels, the last one ragged,
      and the chunks go to ``slices`` slices (``wgrad_config``'s by
      default), slice s taking chunks [s * chunks // S, (s + 1) * chunks //
      S); for each slice, each tile of ``rows`` dW rows x ``tile_n`` columns
      is the product of the slice's rounded patch values and g's rows in
      f32; the slices' partials are summed in order.
    - doffsets: each ``rows``-channel chunk of a tap sums its channels'
      offset terms; the chunks' partials are summed in order, then clipped.

    Returns (dW (9C, Cout) float32, doffsets (B, Ho, Wo, 18) float32)."""
    b, h, w, c = x.shape
    m, cout = g.shape
    conf = wgrad_config(c, cout, m, sms=sms, bf16=x.dtype == torch.bfloat16)
    n_slices = slices or conf["slices"]
    rows, tile_n, chunk, chunks = conf["rows"], conf["tile_n"], conf["chunk"], conf["chunks"]
    patches, terms_y, terms_x = offset_grad_terms(x, offsets, dpatch, stride=stride,
                                                  dilation=dilation, radius=radius)
    a = patches.to(x.dtype).float().reshape(m, 9 * c)
    gf = g.float()
    dw = None
    for s in range(n_slices):
        lo = s * chunks // n_slices * chunk
        hi = min((s + 1) * chunks // n_slices * chunk, m)
        part = torch.empty((9 * c, cout), dtype=torch.float32, device=g.device)
        for r0 in range(0, 9 * c, rows):
            for n0 in range(0, cout, tile_n):
                part[r0:r0 + rows, n0:n0 + tile_n] = (a[lo:hi, r0:r0 + rows].t()
                                                      @ gf[lo:hi, n0:n0 + tile_n])
        dw = part if dw is None else dw + part
    doff = None
    for k in range(c // rows):
        chans = slice(k * rows, (k + 1) * rows)
        part = torch.stack([terms_y[..., chans].sum(-1), terms_x[..., chans].sum(-1)], -1)
        doff = part if doff is None else doff + part
    doff = clip_offset_grad(doff, offsets, radius)
    return dw, doff.reshape(b, offsets.shape[1], offsets.shape[2], 18)
