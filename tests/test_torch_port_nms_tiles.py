"""Port parity, K2's tile sweep on the CPU.

The card runs greedy NMS as two launches (``csrc/nms.cu``): a mask kernel
that writes the packed upper tiles of the suppression bitmask, and a sweep
that resolves 64 rows a step from them. Their model, tile for tile, is
``nms_mask_tiles`` below (on ``nms_tile_mask``): the algorithm of the
kernels in torch, kept here since no path runs it. It is held bit
for bit against the plain version ``nms_mask_sorted_plain``, the JAX
package's ``nms_mask`` and the fixture ``tests/fixtures/nms.npz`` on awkward
problems: ragged N, more than one 32-word chunk a row tile, invalid rows,
duplicates, a box that suppresses every later row, NaN and zero-area boxes,
IoUs exactly at the threshold, and batches of problems with different valid
counts. The packed layout and the kernel's constants are checked against
the source, and the split tool's edits must find their launches.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mxdetection_tpu.ops import nms as jnms

from mxdetection_tpu_torch.ops import boxes as tbox
from mxdetection_tpu_torch.ops import nms as tnms
from mxdetection_tpu_torch.ops.cuda import k2_variants
from mxdetection_tpu_torch.ops.cuda.build import CSRC_DIR

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

NMS_TILE = 64   # rows of a row tile, bits of a mask word (csrc/nms.cu kTile)
NMS_CHUNK = 32  # word columns the sweep holds at a time (csrc/nms.cu kChunk)


def nms_tile_offset(t: int, cb: int) -> int:
    """Tiles of a problem's packed mask before row tile ``t``'s block."""
    return t * (2 * cb - t + 1) // 2


def nms_tile_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """The packed upper-tile suppression mask of K2's first launch: boxes
    (P, N, 4), valid (P, N) -> (P, cb(cb+1)/2, 64) int64, cb = ceil(N/64).
    Tile (t, w), w >= t, sits at ``nms_tile_offset(t, cb) + w - t``; its word
    r belongs to row t*64+r, and its bit k is set iff column j = w*64+k is
    later than the row, the row is valid and IoU(row, j) > iou_thr."""
    p, n = valid.shape
    cb = -(-n // NMS_TILE)
    idx = torch.arange(n, device=boxes.device)
    over = tbox.pairwise_iou(boxes.float(), boxes.float()) > iou_thr
    over &= valid[:, :, None] & (idx[None, :] > idx[:, None])
    pad = cb * NMS_TILE - n
    over = F.pad(over, (0, pad, 0, pad)).view(p, cb, NMS_TILE, cb, NMS_TILE)
    # bits are distinct powers of two, so their sum is their OR (bit 63: -2^63)
    words = (over.long() << torch.arange(NMS_TILE, device=boxes.device)).sum(-1)
    t, w = torch.triu_indices(cb, cb, device=boxes.device)  # row by row, w = t..cb-1
    return words[:, t, :, w].permute(1, 0, 2).contiguous()


def nms_mask_tiles(boxes: torch.Tensor, valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """Plain model of K2, tile for tile: the packed mask of
    ``nms_tile_mask`` swept 64 rows a step, as ``csrc/nms.cu`` sweeps it,
    (P, N, 4), (P, N) -> keep (P, N) bool. At row tile t the tile's rows are
    resolved in order from removed[t] and their diagonal words, then each
    later word of the set ORs in the words of the tile's kept rows, one
    chunk of ``NMS_CHUNK`` word columns at a time. Invalid rows and the
    ragged tail start removed."""
    p, n = valid.shape
    cb = -(-n // NMS_TILE)
    mask = nms_tile_mask(boxes, valid, iou_thr)
    bit = torch.arange(NMS_TILE, device=boxes.device)
    gone = F.pad(~valid, (0, cb * NMS_TILE - n), value=True)
    removed = (gone.view(p, cb, NMS_TILE).long() << bit).sum(-1)  # (P, cb)
    keep = torch.zeros((p, cb, NMS_TILE), dtype=torch.bool, device=boxes.device)
    for t in range(cb):
        block = mask[:, nms_tile_offset(t, cb):nms_tile_offset(t + 1, cb)]  # (P, cb - t, 64)
        rem = removed[:, t].clone()
        for b in range(NMS_TILE):
            alive = (rem >> b) & 1 == 0
            rem = torch.where(alive, rem | block[:, 0, b], rem)
        kept = (~rem[:, None] >> bit) & 1 == 1  # (P, 64)
        keep[:, t] = kept
        for c0 in range(0, cb - t, NMS_CHUNK):
            cols = block[:, c0:c0 + NMS_CHUNK]
            acc = torch.zeros(cols.shape[:2], dtype=torch.int64, device=boxes.device)
            for b in range(NMS_TILE):
                acc |= torch.where(kept[:, b, None], cols[:, :, b], 0)
            if c0 == 0:
                acc[:, 0] = 0  # the diagonal word column is used up
            removed[:, t + c0:t + c0 + cols.shape[1]] |= acc
    return keep.view(p, cb * NMS_TILE)[:, :n]


def clustered(rng, counts, n, clusters=8):
    """Score-sorted boxes (P, N, 4) f32 around a few centres, valid (P, N):
    the rows past each problem's count are padding."""
    p = len(counts)
    centers = rng.uniform([0.0, 0.0], [400.0, 300.0], (p, clusters, 2))
    pick = rng.integers(0, clusters, (p, n))
    c = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    c = c + rng.normal(0.0, 8.0, (p, n, 2))
    wh = np.exp(rng.uniform(2.5, 4.5, (p, n, 2)))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).clip(0, 400).astype(np.float32)
    return boxes, np.arange(n)[None, :] < np.asarray(counts)[:, None]


def at_threshold():
    """Four pairs of boxes, apart from each other; the second box of a pair
    has an IoU with the first of exactly 0.7 (70 / 100), exactly 0.5 (50 /
    100), just over 0.5 and just over 0.7, in f32 arithmetic. Rows: the four
    first boxes, then the four second ones."""
    first = [[x, 0, x + 10, 10] for x in (0, 20, 40, 60)]
    second = [[0, 0, 10, 7], [20, 0, 30, 5], [40, 0, 50, 5.0001], [60, 0, 70, 7.0001]]
    return np.array([first + second], np.float32)


def make_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    ragged = {"n1": [1, 0], "n63": [63, 40], "n64": [64, 1], "n65": [65, 64],
              "n130": [130, 129, 66, 2]}
    if name in ragged:
        counts = ragged[name]
        boxes, valid = clustered(rng, counts, max(counts))
        return boxes, valid, 0.7
    if name == "n2100_holes":  # two 32-word chunks in the first row tiles
        boxes, valid = clustered(rng, [2100, 2063], 2100, clusters=60)
        return boxes, valid & (rng.random(valid.shape) > 0.1), 0.7
    if name == "all_invalid":
        boxes, valid = clustered(rng, [100, 100], 100)
        return boxes, np.zeros_like(valid), 0.7
    if name == "holes":
        boxes, valid = clustered(rng, [200, 200, 200], 200)
        return boxes, valid & (rng.random(valid.shape) > 0.3), 0.5
    if name == "duplicates":
        boxes, valid = clustered(rng, [150, 120], 150)
        boxes[:, 50:100] = boxes[:, 0:50]
        return boxes, valid, 0.7
    if name == "suppress_all":
        first = np.array([100, 100, 300, 300], np.float32)
        boxes = (first + rng.uniform(-1, 1, (2, 300, 4))).astype(np.float32)
        return boxes, np.ones((2, 300), bool), 0.7
    if name == "nan_zero_area":
        boxes, valid = clustered(rng, [140, 140, 100], 140)
        boxes[:, 5::17, 1] = np.nan
        boxes[:, 9::23] = 0.0
        boxes[2, 3, 2] = boxes[2, 3, 0]
        boxes[:, 40:60] = boxes[:, 20:40]
        return boxes, valid, 0.5
    if name.startswith("at_thr_"):
        return at_threshold(), np.ones((1, 8), bool), float(name[len("at_thr_"):])
    raise KeyError(name)


CASES = ["n1", "n63", "n64", "n65", "n130", "n2100_holes", "all_invalid", "holes",
         "duplicates", "suppress_all", "nan_zero_area", "at_thr_0.5", "at_thr_0.7"]


def jax_keep(boxes, valid, thr):
    """The JAX ``nms_mask`` of each score-sorted problem (distinct
    descending scores keep the order)."""
    p, n = valid.shape
    scores = -jnp.arange(n, dtype=jnp.float32)
    fn = jax.vmap(lambda b, v: jnms.nms_mask(b, scores, thr, v))
    return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(valid)))


@pytest.mark.parametrize("name", CASES)
def test_tile_sweep_matches_plain_and_jax(name):
    """The tile model's keep mask equals the plain sweep's and JAX's, bit
    for bit."""
    boxes, valid, thr = make_case(name)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = nms_mask_tiles(tb, tv, thr).numpy()
    plain = tnms.nms_mask_sorted_plain(tb, tv, thr).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_keep(boxes, valid, thr))
    assert not got[~valid].any()


def test_cases_exercise_what_they_name():
    """The awkward cases do what they are there for."""
    keep = {name: nms_mask_tiles(*(torch.from_numpy(x) for x in make_case(name)[:2]),
                                      make_case(name)[2]) for name in
            ("suppress_all", "at_thr_0.5", "at_thr_0.7", "duplicates", "n130")}
    assert keep["suppress_all"].sum(-1).tolist() == [1, 1]
    # a second box at IoU exactly at the threshold stays, one just over goes
    assert keep["at_thr_0.5"][0].tolist() == [True] * 4 + [False, True, False, False]
    assert keep["at_thr_0.7"][0].tolist() == [True] * 7 + [False]
    assert not keep["duplicates"][:, 50:100][keep["duplicates"][:, 0:50]].any()
    assert keep["n130"].sum(-1).tolist()[3] == 2
    iou = tbox.pairwise_iou(torch.from_numpy(at_threshold()), torch.from_numpy(at_threshold()))
    assert iou[0, 0, 4].item() == np.float32(0.7) and iou[0, 1, 5].item() == np.float32(0.5)


def test_tile_sweep_matches_fixture():
    """``tests/fixtures/nms.npz``: sorted by score, swept by tiles and
    scattered back, at three thresholds, equal to JAX's ``nms_mask``."""
    d = np.load("tests/fixtures/nms.npz")
    boxes, scores, valid = d["boxes"], d["scores"], d["valid"]
    order = torch.sort(torch.from_numpy(scores), descending=True, stable=True).indices
    tb = torch.from_numpy(boxes)[order][None]
    tv = torch.from_numpy(valid)[order][None]
    for thr in (0.3, 0.5, 0.7):
        keep = torch.zeros(len(scores), dtype=torch.bool)
        keep[order] = nms_mask_tiles(tb, tv, thr)[0]
        np.testing.assert_array_equal(keep.numpy(), np.asarray(
            jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr, jnp.asarray(valid))))


@pytest.mark.parametrize("n", [1, 64, 130, 2100])
def test_tile_mask_layout(n):
    """The packed mask holds the upper tiles row tile by row tile, each tile
    its 64 row words, and the word of (row, tile) carries the bits of the
    later overlapping columns of a valid row."""
    boxes, valid = clustered(np.random.default_rng(n), [n, max(n - 3, 0)], n)
    thr = 0.5
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    mask = nms_tile_mask(tb, tv, thr)
    cb = -(-n // 64)
    assert mask.shape == (2, cb * (cb + 1) // 2, 64)
    assert [nms_tile_offset(t, cb) for t in range(cb + 1)] == \
        [sum(cb - s for s in range(t)) for t in range(cb + 1)]
    over = (tbox.pairwise_iou(tb, tb) > thr) & tv[:, :, None]
    over &= torch.arange(n)[None, :] > torch.arange(n)[:, None]
    rng = np.random.default_rng(0)
    for _ in range(40):
        t = int(rng.integers(cb))
        w = int(rng.integers(t, cb))
        r = int(rng.integers(64))
        word = int(mask[1, nms_tile_offset(t, cb) + w - t, r])
        row = t * 64 + r
        want = 0
        for k in range(64):
            j = w * 64 + k
            if row < n and j < n and bool(over[1, row, j]):
                want |= 1 << k
        assert word & (2 ** 64 - 1) == want


def test_kernel_constants_match_the_model():
    """The tile and chunk of ``csrc/nms.cu`` are the model's."""
    with open(os.path.join(CSRC_DIR, "nms.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == NMS_TILE
    assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == NMS_CHUNK


def test_split_edits_find_the_launches():
    """``k2_variants --split`` drops exactly one launch of the entry point."""
    edits = k2_variants.split_edits(CSRC_DIR)
    assert edits["whole"] == []
    assert "nms_sweep_kernel<<<" in edits["mask_only"][0][0]
    assert "nms_mask_kernel<<<" in edits["sweep_only"][0][0]
    with pytest.raises(ValueError, match="launches"):
        k2_variants.drop_launch("int x;\n", "nms_mask_kernel")
