"""Port parity, the deformable conv's fused weight gradient (K6/K6b,
``csrc/deform_conv_bwd.cu::wg::wgrad_kernel``): its plain version
``ops/dcn.py::deform_wgrad_doffsets`` against ``jax.grad`` of the JAX
gather, and the kernel's partition of the sums, modelled on the CPU by
``ops/cuda/deform_conv.py::wgrad_split``.

A block of the kernel owns a tile of 64 dW rows (one tap, 64 channels) x
one column tile and walks a slice of the output pixels in chunks, the last
chunk ragged; the slices' partial dW tiles are summed in order, and the
offset gradient of a (pixel, tap) is summed over its 64-channel chunks. The
model must add up to the plain version for one column tile or two, two to
eight channel chunks and one to three slices. It reads the kernel's tile
sizes and slice rule from the kernel source; g's layout for the kernel's
wgmma (``wgmma_g_tiles``) reads back as documented. The kernel itself runs
only on the card (``chip_smoke.py`` phase 10, which also holds the model's
partition against the built kernel's).
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
from mxdetection_tpu_torch.ops.cuda import k6_variants

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)


def wgrad_case(seed, b, h, w, c, cout, stride, std=2.0):
    """x, offsets (normal, ``std`` cells: some beyond +-3, some sampling
    outside the map), W, the output gradient g (B * Ho * Wo, Cout) and
    dpatch = g W^T, float32 numpy."""
    rng = np.random.RandomState(seed)
    ho, wo = -(-h // stride), -(-w // stride)
    x = rng.randn(b, h, w, c).astype(np.float32)
    off = (rng.randn(b, ho, wo, 18) * std).astype(np.float32)
    wt = (rng.randn(3, 3, c, cout) * 0.1).astype(np.float32)
    g = rng.randn(b * ho * wo, cout).astype(np.float32)
    dp = (g @ wt.reshape(9 * c, cout).T).reshape(b, ho, wo, 9 * c)
    return x, off, wt, g, dp


def assert_close(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("radius", [None, 3])
def test_wgrad_doffsets_matches_jax_grad(stride, dilation, radius):
    """dW and doffsets of ``deform_wgrad_doffsets`` against ``jax.grad`` in
    the weight and the offsets of the JAX gather
    (``mxdetection_tpu/ops/dcn.py::deform_conv2d``, with ``jnp.clip`` for
    ``radius``), within 1e-5 of the largest value: the same f32 formulas,
    summed in another order."""
    x, off, wt, g, dp = wgrad_case(110 + 4 * stride + 2 * dilation + (radius or 0), 2, 9, 11, 8,
                                   12, stride)
    b, ho, wo = off.shape[:3]
    gmap = g.reshape(b, ho, wo, -1)

    def loss(off, w):
        if radius is not None:
            off = jnp.clip(off, -radius, radius)
        out = jax.vmap(lambda xi, oi: jdcn.deform_conv2d(xi, oi, w, stride=stride,
                                                          dilation=dilation))(x, off)
        return jnp.sum(out * gmap)

    ref_off, ref_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(off), jnp.asarray(wt))
    dw, doff = tdcn.deform_wgrad_doffsets(*(torch.from_numpy(a) for a in (x, off, dp, g)),
                                          stride=stride, dilation=dilation, radius=radius)
    assert dw.dtype == torch.float32 and dw.shape == (9 * 8, 12)
    assert_close(dw.numpy(), np.asarray(ref_w).reshape(9 * 8, 12), 1e-5, "dW")
    assert_close(doff.numpy(), ref_off, 1e-5, "doffsets")
    if radius is not None:
        assert (doff.numpy()[np.abs(off) > radius] == 0).all() and (np.abs(off) > radius).any()


# ---------------------------------------------------------------- K6's partition

SPLIT_CASES = {  # name: (C, Cout, dtype, radius)
    "c128_cout128_bf16": (128, 128, torch.bfloat16, None),
    "c256_cout256_bf16_radius3": (256, 256, torch.bfloat16, 3),
    "c512_cout512_bf16": (512, 512, torch.bfloat16, None),
    "c128_cout192_f32": (128, 192, torch.float32, None),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_wgrad_split_adds_up_to_plain(case):
    """The kernel's partition (``wgrad_split``) with one, two and three
    slices of M, its last pixel chunk ragged, one or two column tiles
    and two to eight 64-channel chunks, within 1e-6 of the largest value of
    ``deform_wgrad_doffsets`` on the same inputs, rounded to the kernel's
    dtype: every (row, column, pixel) term lands in exactly one tile of one
    slice, every channel of a (pixel, tap) in one channel chunk."""
    c, cout, dtype, radius = SPLIT_CASES[case]
    chunk = cuda_dcn.wgrad_config(c, cout, 1, bf16=dtype == torch.bfloat16)["chunk"]
    w = chunk // 4 + 3  # 2 x 5 x w pixels: three chunks or more, the last ragged
    x, off, _, g, dp = (torch.from_numpy(a) for a in wgrad_case(120 + c + cout, 2, 5, w, c, cout, 1))
    x, dp, g = x.to(dtype), dp.to(dtype), g.to(dtype)
    conf = cuda_dcn.wgrad_config(c, cout, g.shape[0], bf16=dtype == torch.bfloat16)
    assert conf["chunks"] >= 3 and g.shape[0] % conf["chunk"] != 0
    assert cout // conf["tile_n"] == {128: 1, 256: 1, 512: 2, 192: 3}[cout]
    ref_dw, ref_doff = tdcn.deform_wgrad_doffsets(x, off, dp, g, radius=radius)
    for slices in (1, 2, 3):
        dw, doff = cuda_dcn.wgrad_split(x, off, dp, g, radius=radius, slices=slices)
        assert_close(dw.numpy(), ref_dw.numpy(), 1e-6, f"dW, {slices} slices")
        assert_close(doff.numpy(), ref_doff.numpy(), 1e-6, f"doffsets, {slices} slices")


def test_wgrad_config_slices_at_the_main_path_shapes():
    """The slice rule at the six DCN layer shapes of Cascade R101-DCN at
    batch 8, 832x1344, on an H100's 132 SMs: a whole number of waves of one
    block an SM or close to it (stage 2: 18 tiles x 7 slices; stage 3: 36 x
    11 = 3 waves; stage 4: 144 x 4, capped by its 137 chunks of 64 pixels),
    at least ``kWgMinChunks`` chunks a slice."""
    want = {(128, 104 * 168): (128, 7), (256, 52 * 84): (256, 11), (512, 26 * 42): (256, 4)}
    for (c, hw), (tile_n, slices) in want.items():
        conf = cuda_dcn.wgrad_config(c, c, 8 * hw)
        assert conf["chunk"] == 64 and conf["chunks"] == -(-8 * hw // 64)
        assert (conf["tile_n"], conf["slices"]) == (tile_n, slices), (c, conf)
        assert conf["chunks"] // conf["slices"] >= 32
    assert cuda_dcn.wgrad_config(256, 256, 100)["slices"] == 1  # too few chunks to split
    assert cuda_dcn.wgrad_config(128, 128, 8 * 104 * 168, sms=114)["slices"] != 7


def test_wgrad_config_reads_the_kernel_source(tmp_path):
    """``wgrad_config`` reads the tile sizes and the slice rule's constants
    from ``deform_conv_bwd.cu``: a copy of the source with one slice at most
    (``k6_variants``' one_slice) gives one slice."""
    m = 8 * 52 * 84
    base = cuda_dcn.wgrad_config(256, 256, m)
    csrc = k6_variants.make_variant("one_slice", build.CSRC_DIR, str(tmp_path / "one_slice"))
    conf = cuda_dcn.wgrad_config(256, 256, m, csrc_dir=csrc)
    assert base["slices"] > 1 and conf["slices"] == 1
    assert {k: v for k, v in conf.items() if k != "slices"} == {
        k: v for k, v in base.items() if k != "slices"}


@pytest.mark.parametrize("cout", [128, 256, 512])
def test_wgmma_g_tiles_reads_back_as_documented(cout):
    """g's layout for the bf16 kernel (``wgmma_g_tiles``, the plain version
    of the card's layout pass), read back by its documented rule, is g
    element for element, zero past M: element (j, kc, a, k, 8 s + e) is
    g[chunk kc + k, tile_n j + 64 a + 8 (s ^ k % 8) + e]."""
    m = 150  # three chunks of 64 pixels, the last ragged
    g = torch.from_numpy(np.random.RandomState(cout).randn(m, cout).astype(np.float32)).bfloat16()
    conf = cuda_dcn.wgrad_config(64, cout, m)
    tile_n, chunk, chunks = conf["tile_n"], conf["chunk"], conf["chunks"]
    assert tile_n == cuda_dcn.bf16_tile_n(cout) and m % chunk != 0
    tiles = cuda_dcn.wgmma_g_tiles(g, tile_n, chunk)
    assert tiles.shape == (cout // tile_n, chunks, tile_n // 64, chunk, 64)
    assert tiles.is_contiguous()
    j, kc, a, k, v = np.meshgrid(*[np.arange(d) for d in tiles.shape], indexing="ij")
    read = tiles.float().numpy()[j, kc, a, k, ((v // 8) ^ (k % 8)) * 8 + v % 8]
    padded = np.zeros((chunks * chunk, cout), np.float32)
    padded[:m] = g.float().numpy()
    np.testing.assert_array_equal(read, padded[chunk * kc + k, tile_n * j + 64 * a + v])
    last = m - (chunks - 1) * chunk
    assert not tiles[:, -1, :, last:].float().any()  # the ragged chunk's rows past M
    # the swizzle moves data: pixel row k = 1 stores its second 16-byte group first
    np.testing.assert_array_equal(tiles[0, 0, 0, 1, :8].float().numpy(), g[1, 8:16].float().numpy())


@pytest.mark.parametrize("name", sorted(k6_variants.VARIANTS))
def test_k6_variant_edits_apply(name, tmp_path):
    """Each variant that ``ops/cuda/k6_variants.py`` times on the card is one
    edit set that still applies, each edit exactly once, to the kernel
    source; only ``deform_conv_bwd.cu`` changes."""
    csrc = k6_variants.make_variant(name, build.CSRC_DIR, str(tmp_path / name))
    assert sorted(os.listdir(csrc)) == sorted(os.listdir(build.CSRC_DIR))
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as a, open(os.path.join(build.CSRC_DIR, f)) as b:
            same = a.read() == b.read()
        assert same == (f != k6_variants.SOURCE or name == "base"), f
