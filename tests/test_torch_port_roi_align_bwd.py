"""Port parity, the RoIAlign backward (K3, with the bf16 convert K3b as its
epilogue, ``csrc/roi_align_bwd.cu``): its partition of the sum into output
tiles, modelled on the CPU by ``ops/cuda/roi_align.py::roi_align_bwd_tiles``.

A block of the kernel owns a tile of a level's gradient, lists the rois
whose footprint meets the tile in roi-index order and adds their terms
(g / S^2) * (wy * wx) in a fixed order, then writes the tile once in the
caller's dtype. The model, which reads the kernel's tile from its source,
must match autograd of ``ops/roi_align.py::multilevel_roi_align_plain`` and
``jax.vjp`` of the JAX XLA RoIAlign (``mxdetection_tpu/ops/roi_align.py``)
on every awkward case: taps that coincide at the last row and column,
rois narrower than a cell, samples outside the map, aspect ratios past
24:1, ragged tiles and channel chunks, and a cluster of rois on one tile.
Its bf16 output is its f32 output rounded. The kernel itself runs only on
the card (``chip_smoke.py`` phase 5, which also holds it against the model
bit for bit and its tile against the model's).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from mxdetection_tpu.ops import roi_align as jra

from mxdetection_tpu_torch.ops import roi_align as tra
from mxdetection_tpu_torch.ops.cuda import build
from mxdetection_tpu_torch.ops.cuda import k3_variants
from mxdetection_tpu_torch.ops.cuda import roi_align as cra

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

CHUNK = cra.roi_align_bwd_config()["chunk"]


def _rois(cx, cy, w, h):
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


CASES = ["general", "duplicate_taps", "narrow", "outside", "aspect", "ragged", "cluster"]


def _case(name):
    """(level shapes, strides, rois (B, R, 4), levels (B, R), valid (B, R),
    channels) of one case, from a numpy seed."""
    rng = np.random.RandomState(50 + CASES.index(name))
    shapes, strides, c = [(16, 24), (8, 12)], (4, 8), 6
    levels = None
    if name == "general":
        b, r = 2, 14
        side = np.exp(rng.uniform(1.5, 5.0, (b, r)))
        rois = _rois(rng.uniform(-10, 106, (b, r)), rng.uniform(-10, 74, (b, r)),
                     side * rng.uniform(0.5, 2.0, (b, r)), side)
    elif name == "duplicate_taps":  # samples past size - 1 clamp: lo == hi at the edge
        shapes = [(9, 13), (1, 7)]  # level 1 is one row: lo == hi == 0 for every sample
        b, r = 1, 8
        x2 = np.asarray([52, 52, 56, 60, 52, 56, 30, 60], np.float32)
        y2 = np.asarray([36, 40, 36, 44, 8, 10, 6, 12], np.float32)
        rois = np.stack([x2 - rng.uniform(2, 20, r), y2 - rng.uniform(2, 8, r), x2, y2],
                        -1)[None].astype(np.float32)
        levels = np.asarray([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32)
    elif name == "narrow":  # narrower than a cell: all P*S samples in one or two cells
        b, r = 1, 8
        rois = _rois(rng.uniform(4, 90, (b, r)), rng.uniform(4, 60, (b, r)),
                     rng.uniform(0.05, 3.0, (b, r)), rng.uniform(0.05, 3.0, (b, r)))
    elif name == "outside":  # samples beyond [-1, size] weigh 0; in [-1, 0) clamp to 0
        b, r = 1, 8
        rois = np.asarray([[[-30, -20, 10, 14], [-6, -5, 30, 20], [80, 50, 140, 100],
                            [-50, -40, -10, -8], [100, 70, 160, 120], [-3.9, 2, 20, 30],
                            [60, -3.5, 95, 40], [-20, 10, 120, 50]]], np.float32)
    elif name == "aspect":  # past the Pallas kernel's 24:1 limit
        b, r = 1, 6
        rois = np.asarray([[[2, 30, 94, 32], [40, 1, 41.5, 62], [0, 10, 96, 11],
                            [-20, 40, 120, 42.5], [10, -10, 12, 80], [5, 20, 90, 23]]],
                          np.float32)
    elif name == "ragged":  # no side a multiple of the tile, a ragged last channel chunk
        shapes, c = [(19, 13), (10, 7)], CHUNK + 3
        b, r = 1, 6
        side = np.exp(rng.uniform(2.0, 4.5, (b, r)))
        rois = _rois(rng.uniform(0, 52, (b, r)), rng.uniform(0, 76, (b, r)), side, side * 1.3)
    elif name == "cluster":  # a training step's foreground: rois jittered around one box
        b, r = 1, 40
        rois = _rois(40 + rng.randn(b, r) * 3, 30 + rng.randn(b, r) * 3,
                     24 * np.exp(rng.randn(b, r) * 0.2), 20 * np.exp(rng.randn(b, r) * 0.2))
    else:
        raise KeyError(name)
    valid = rng.rand(b, r) > 0.15
    valid[:, 0] = True
    if levels is None:
        levels = (rng.rand(b, r) > (0.5 if name in ("general", "ragged") else 1.0)).astype(
            np.int32)
    return shapes, strides, rois, levels, valid, c


def _inputs(name, seed=0):
    shapes, strides, rois, levels, valid, c = _case(name)
    g = np.random.RandomState(seed).randn(*rois.shape[:2], 7, 7, c).astype(np.float32)
    return shapes, strides, rois, levels, valid, g


def _model(name, **kw):
    shapes, strides, rois, levels, valid, g = _inputs(name)
    return cra.roi_align_bwd_tiles(torch.from_numpy(g), shapes, torch.from_numpy(rois), strides,
                                   torch.from_numpy(levels), roi_valid=torch.from_numpy(valid),
                                   **kw)


def _autograd(name, magnitude=False):
    """Autograd of the plain RoIAlign; with ``magnitude``, of |g|: each
    cell's sum of the magnitudes of its terms (the weights are >= 0)."""
    shapes, strides, rois, levels, valid, g = _inputs(name)
    g = np.abs(g) if magnitude else g
    b, c = g.shape[0], g.shape[-1]
    leaves = [torch.zeros((b, h, w, c), requires_grad=True) for h, w in shapes]
    out = tra.multilevel_roi_align_plain(leaves, torch.from_numpy(rois), strides,
                                         torch.from_numpy(levels),
                                         roi_valid=torch.from_numpy(valid))
    return torch.autograd.grad(out, leaves, torch.from_numpy(g))


@pytest.mark.parametrize("name", CASES)
def test_tiles_match_autograd_of_plain(name):
    """The model's f32 gradient against autograd of the plain RoIAlign: the
    same terms, bit for bit, summed in another order, so each cell within
    1e-6 of the sum of its terms' magnitudes (the bound of a reordered f32
    sum; the cluster's cells sum some 160 terms); the same cells touched."""
    got, pairs, longest = _model(name)
    ref, mag = _autograd(name), _autograd(name, magnitude=True)
    assert max(float(x.abs().max()) for x in ref) > 0 and pairs > 0 and longest > 0
    for lvl, (a, e, m) in enumerate(zip(got, ref, mag)):
        assert a.dtype == torch.float32 and a.shape == e.shape
        err = (a - e).abs()
        assert bool((err <= 1e-6 * m).all()), (lvl, float((err / m.clamp(min=1e-30)).max()))
        assert torch.equal(a != 0, e != 0), f"level {lvl}: another set of touched cells"


@pytest.mark.parametrize("name", CASES)
def test_tiles_match_jax_vjp(name):
    """The model against ``jax.vjp`` of the JAX XLA RoIAlign, image by
    image, on the same levels: the same terms summed in another order, so
    each cell within 1e-6 of the sum of its terms' magnitudes (a flat 1e-5
    would not hold for the cluster, whose cells reach 10)."""
    shapes, strides, rois, levels, valid, g = _inputs(name)
    got, _, _ = _model(name)
    mag = _autograd(name, magnitude=True)
    feats = [np.zeros((g.shape[0], h, w, g.shape[-1]), np.float32) for h, w in shapes]
    for i in range(g.shape[0]):
        _, vjp = jax.vjp(lambda fs: jra.multilevel_roi_align(
            fs, rois[i], strides, roi_valid=valid[i], levels=levels[i]), [f[i] for f in feats])
        ref = vjp(g[i])[0]
        for lvl in range(len(shapes)):
            err = np.abs(got[lvl][i].numpy() - np.asarray(ref[lvl]))
            assert (err <= 1e-6 * mag[lvl][i].numpy()).all(), (i, lvl, err.max())


@pytest.mark.parametrize("name", CASES)
def test_bf16_is_f32_rounded(name):
    """K3b's function: the bf16 gradient is the f32 one rounded to nearest
    even, bit for bit, from a bf16 upstream gradient as on the main path."""
    shapes, strides, rois, levels, valid, g = _inputs(name)
    g16 = torch.from_numpy(g).bfloat16()
    args = (shapes, torch.from_numpy(rois), strides, torch.from_numpy(levels))
    kw = {"roi_valid": torch.from_numpy(valid)}
    f32, _, _ = cra.roi_align_bwd_tiles(g16, *args, **kw)
    bf16, _, _ = cra.roi_align_bwd_tiles(g16, *args, out_dtype=torch.bfloat16, **kw)
    for a, x in zip(f32, bf16):
        assert x.dtype == torch.bfloat16 and torch.equal(x, a.to(torch.bfloat16))


@pytest.mark.parametrize("name", CASES)
def test_footprint_is_the_box_of_touched_cells(name):
    """Each roi's footprint is exactly the bounding box of the cells its
    samples touch with a nonzero weight (samples outside the map neither
    widen it nor add a term), empty for an invalid roi or one wholly
    outside; the vectorised pair count and longest list equal the model's."""
    shapes, strides, rois, levels, valid, _ = _inputs(name)
    rois_t, levels_t, valid_t = (torch.from_numpy(x) for x in (rois, levels, valid))
    taps = tra.roi_sample_taps(rois_t, levels_t, shapes, strides)
    fp = cra.roi_footprints(taps, valid_t)
    b, r = valid.shape
    for i in range(b):
        for j in range(r):
            one = torch.zeros((b, r, 7, 7, 1))
            one[i, j] = 1.0
            leaves = [torch.zeros((b, h, w, 1), requires_grad=True) for h, w in shapes]
            out = tra.multilevel_roi_align_plain(leaves, rois_t, strides, levels_t,
                                                 roi_valid=valid_t)
            grad = torch.autograd.grad(out, leaves, one)[levels[i, j]][i, ..., 0]
            ys, xs = torch.nonzero(grad, as_tuple=True)
            if ys.numel() == 0:
                assert fp[i, j, 0] > fp[i, j, 1], (i, j)
            else:
                box = [int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max())]
                assert fp[i, j].tolist() == box, (i, j)
    _, pairs, longest = _model(name)
    assert cra.roi_tile_pairs(fp, levels_t, shapes) == (pairs, longest)


def test_cluster_puts_its_rois_on_one_tile():
    """The load-imbalance case: the cluster's 40 rois (some invalid) all
    meet the tile that holds the box's centre, so the longest list is the
    number of valid rois; other tiles hold fewer."""
    _, _, _, _, valid, _ = _inputs("cluster")
    _, pairs, longest = _model("cluster")
    assert longest == int(valid.sum()) and pairs > longest


def test_tile_shape_does_not_change_the_sums():
    """Another tile shape gives other lists and pair counts, and the same
    gradient within the tolerance of the order of the sums; the kernel's
    tile is read from its source, and an edited copy's tile from the copy."""
    name = "general"
    ref, mag = _autograd(name), _autograd(name, magnitude=True)
    _, pairs, _ = _model(name)
    other, other_pairs, _ = _model(name, tile=(4, 16))
    assert other_pairs != pairs
    for a, e, m in zip(other, ref, mag):
        assert bool(((a - e).abs() <= 1e-6 * m).all())
    conf = cra.roi_align_bwd_config()
    assert conf == {"tile": conf["tile"], "chunk": CHUNK, "threads": 32 * conf["tile"][0]}


@pytest.mark.parametrize("name", sorted(k3_variants.VARIANTS))
def test_k3_variant_edits_apply(name, tmp_path):
    """Each variant that ``ops/cuda/k3_variants.py`` times on the card is one
    edit set that still applies, each edit exactly once, to the kernel
    source; only ``roi_align_bwd.cu`` changes, and the model reads an edited
    tile or lane width from the copy."""
    csrc = k3_variants.make_variant(name, build.CSRC_DIR, str(tmp_path / name))
    assert sorted(os.listdir(csrc)) == sorted(os.listdir(build.CSRC_DIR))
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as a, open(os.path.join(build.CSRC_DIR, f)) as b:
            same = a.read() == b.read()
        assert same == (f != k3_variants.SOURCE or name == "base"), f
    conf = cra.roi_align_bwd_config(csrc)
    if name.startswith("tile_"):
        assert conf["tile"] == tuple(int(n) for n in name.split("_")[1].split("x"))
    if name.startswith("lane_8"):
        assert conf["chunk"] == 256
