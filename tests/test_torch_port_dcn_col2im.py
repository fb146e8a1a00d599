"""Port parity, the deformable conv's dx kernel (K7/K7b,
``csrc/deform_conv_bwd.cu::deform_col2im_kernel``): its partition of the
sum, modelled on the CPU by ``ops/cuda/deform_conv.py::col2im_window_split``.

A block of the kernel owns an output tile and adds the terms whose corners
land in the tile's window of dx in one place; the other corners spill
straight into dx. The model's two sums must add up to the plain version
(``ops/dcn.py::deform_col2im``) and to ``jax.grad`` in x of the JAX gather
(``mxdetection_tpu/ops/dcn.py::deform_conv2d``), on ragged tiles, at both
strides and dilations, with and without the offset clamp, and at offsets
that spill nothing and offsets that spill far and off the map; its window
holds offsets from -reach to reach + 1 cells and no more. The model reads
the kernel's tile and reach from the kernel source. The kernel itself runs
only on the card (``chip_smoke.py`` phase 10, which also holds the model's
window against the built kernel's).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxdetection_tpu.ops import dcn as jdcn

from mxdetection_tpu_torch.ops import dcn as tdcn
from mxdetection_tpu_torch.ops.cuda import build
from mxdetection_tpu_torch.ops.cuda import deform_conv as cuda_dcn
from mxdetection_tpu_torch.ops.cuda import k7_variants

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

SHAPES = {1: (11, 21), 2: (19, 37)}  # input H, W: several ragged tiles at each stride


def col2im_case(seed, stride, std, c=8, far=0.0):
    """x's shape, offsets (normal, ``std`` cells; a share ``far`` of them set
    to +-40), dpatch = g W^T and (g, W) for the JAX gradient, float32."""
    rng = np.random.RandomState(seed)
    h, w = SHAPES[stride]
    ho, wo = -(-h // stride), -(-w // stride)
    off = (rng.randn(2, ho, wo, 18) * std).astype(np.float32)
    if far:
        pick = rng.rand(*off.shape) < far
        off[pick] = 40.0 * np.sign(rng.randn(int(pick.sum())))
    wt = (rng.randn(3, 3, c, 6) * 0.3).astype(np.float32)
    g = rng.randn(2, ho, wo, 6).astype(np.float32)
    dpatch = (g.reshape(-1, 6) @ wt.reshape(9 * c, 6).T).reshape(2, ho, wo, 9 * c)
    return (2, h, w, c), off, dpatch, g, wt


def jax_dx(x_shape, off, g, wt, stride, dilation, radius):
    """jax.grad in x of <deform_conv2d(x, off, W), g>; the clamp is applied
    to the offsets first (its gradient in x is the clamped sampling's)."""
    if radius is not None:
        off = np.clip(off, -radius, radius)

    def loss(x):
        out = jax.vmap(lambda xi, oi: jdcn.deform_conv2d(xi, oi, wt, stride=stride,
                                                          dilation=dilation))(x, off)
        return jnp.sum(out * g)

    return np.asarray(jax.grad(loss)(jnp.zeros(x_shape, jnp.float32)))


def split(x_shape, off, dpatch, **kw):
    inside, spilled, n = cuda_dcn.col2im_window_split(torch.from_numpy(dpatch),
                                                      torch.from_numpy(off), x_shape, **kw)
    plain = tdcn.deform_col2im(torch.from_numpy(dpatch), torch.from_numpy(off), x_shape, **kw)
    return inside.numpy(), spilled.numpy(), n, plain.numpy()


def assert_close(got, ref, rtol):
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def off_map_corners(x_shape, off, stride):
    """Corners with a nonzero bilinear weight that lie outside the map."""
    ly, lx, corners = tdcn._corners(x_shape[:3], torch.from_numpy(off), kernel=3, stride=stride,
                                     dilation=1, radius=None)
    return sum(int(((wgt != 0) & (inb == 0)).sum()) for (_, inb), wgt in
               zip(corners, tdcn._bilinear_weights(ly, lx)))


@pytest.mark.parametrize("stride,dilation,radius", [(1, 1, None), (2, 1, None), (1, 2, None),
                                                    (2, 2, None), (1, 1, 3), (2, 1, 3)])
def test_window_split_adds_up_to_col2im_and_jax_grad(stride, dilation, radius):
    """In-window and spilled sums add up to the plain ``deform_col2im``
    within 1e-6 of the largest value (another order of f32 sums) and to
    ``jax.grad`` of the JAX gather within 1e-5, on ragged tiles, with
    offsets of std 2 cells (some beyond the reach, some off the map). With
    the clamp at the reach (``radius=3``) nothing spills."""
    kw = dict(stride=stride, dilation=dilation, radius=radius)
    x_shape, off, dpatch, g, wt = col2im_case(300 + 10 * stride + dilation, stride, 2.0)
    inside, spilled, n, plain = split(x_shape, off, dpatch, **kw)
    assert np.abs(inside).max() > 0
    if radius is None:
        assert n > 0 and np.abs(spilled).max() > 0
    else:
        assert radius <= cuda_dcn.col2im_config(stride)["reach"] and n == 0
    assert_close(inside + spilled, plain, 1e-6)
    assert_close(inside + spilled, jax_dx(x_shape, off, g, wt, stride, dilation, radius), 1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_window_split_small_offsets_spill_nothing(stride):
    """Offsets of std 0.5 cells stay within the kernel's reach: no corner
    spills, and the window's sum alone is ``deform_col2im``."""
    x_shape, off, dpatch, _, _ = col2im_case(320 + stride, stride, 0.5)
    assert np.abs(off).max() < cuda_dcn.col2im_config(stride)["reach"]
    inside, spilled, n, plain = split(x_shape, off, dpatch, stride=stride)
    assert n == 0 and not spilled.any()
    assert_close(inside, plain, 1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_window_split_far_offsets_spill_and_leave_the_map(stride):
    """Offsets of std 6 cells with one in a hundred at +-40: corners spill
    out of their windows and fall off the map, and the two sums still add up
    to ``deform_col2im`` (1e-6) and to ``jax.grad`` of the JAX gather (1e-5)."""
    x_shape, off, dpatch, g, wt = col2im_case(330 + stride, stride, 6.0, far=0.01)
    inside, spilled, n, plain = split(x_shape, off, dpatch, stride=stride)
    assert n > 0 and np.abs(spilled).max() > 0
    assert off_map_corners(x_shape, off, stride) > 0
    assert_close(inside + spilled, plain, 1e-6)
    assert_close(inside + spilled, jax_dx(x_shape, off, g, wt, stride, 1, None), 1e-5)


def test_col2im_config_reads_the_kernel_source(tmp_path):
    """The plain model's tile and reach come from the kernel source: edited
    copies of it (``k7_variants``' reach 2 and 4x8 tile) move them, and the
    window with them. (On the card, ``chip_smoke.py`` holds the model's
    window against the one the built kernel reports.)"""
    base = {s: cuda_dcn.col2im_config(s) for s in (1, 2)}
    csrc = k7_variants.make_variant("reach_2", build.CSRC_DIR, str(tmp_path / "reach_2"))
    conf = cuda_dcn.col2im_config(1, csrc)
    assert base[1]["reach"] != 2 and conf["reach"] == 2 and conf["origin"] == 3
    assert conf["tile"] == base[1]["tile"]
    assert conf["window"] == tuple(n - 2 * (base[1]["reach"] - 2) for n in base[1]["window"])
    csrc = k7_variants.make_variant("tile_s1_4x8", build.CSRC_DIR, str(tmp_path / "tile"))
    assert base[1]["tile"] != (4, 8) and cuda_dcn.col2im_config(1, csrc)["tile"] == (4, 8)
    assert cuda_dcn.col2im_config(2, csrc) == base[2]


@pytest.mark.parametrize("stride", [1, 2])
def test_window_holds_offsets_from_minus_reach_to_reach_plus_one(stride):
    """The window is as wide as the kernel's reach and no wider: with every
    offset set to v cells in both axes, no corner spills for v = -reach and
    v = reach + 1 (the far corner y0 + 1 is in the window), and corners
    spill for v a quarter cell beyond either."""
    reach = cuda_dcn.col2im_config(stride)["reach"]
    x_shape, off, dpatch, _, _ = col2im_case(340 + stride, stride, 1.0, c=4)
    spills = {}
    for v in (-reach - 0.25, -reach, reach + 1.0, reach + 1.25):
        const = np.full_like(off, v)
        inside, spilled, spills[v], plain = split(x_shape, const, dpatch, stride=stride)
        assert_close(inside + spilled, plain, 1e-6)
    assert spills[-reach] == 0 and spills[reach + 1.0] == 0
    assert spills[-reach - 0.25] > 0 and spills[reach + 1.25] > 0


@pytest.mark.parametrize("name", sorted(k7_variants.VARIANTS))
def test_k7_variant_edits_apply(name, tmp_path):
    """Each variant that ``ops/cuda/k7_variants.py`` times on the card is one
    edit set that still applies, each edit exactly once, to the kernel
    source; only ``deform_conv_bwd.cu`` changes."""
    csrc = k7_variants.make_variant(name, build.CSRC_DIR, str(tmp_path / name))
    assert sorted(os.listdir(csrc)) == sorted(os.listdir(build.CSRC_DIR))
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as a, open(os.path.join(build.CSRC_DIR, f)) as b:
            same = a.read() == b.read()
        assert same == (f != k7_variants.SOURCE or name == "base"), f
