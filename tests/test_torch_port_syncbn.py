"""Port parity, SyncBN: the norms of ``mxdetection_tpu_torch.models.layers``
against their flax modules, the ``multihost_dp_faster_rcnn_v5p16`` config
against its two frozen fixtures, ``backbone.remat`` and checkpoints, on the
CPU in one process. The 2-process checks are in ``test_torch_port_dp.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxdetection_tpu.config import load_config as jax_load_config
from mxdetection_tpu.models import layers as jlayers
from mxdetection_tpu.models.registry import build_detector as jax_build_detector

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.models import layers as tlayers
from mxdetection_tpu_torch.models.backbones.resnet import ResNet
from mxdetection_tpu_torch.models.detectors.rcnn import rcnn_loss, rcnn_postprocess
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.train.checkpoint import CheckpointManager
from mxdetection_tpu_torch.train.trainer import Trainer
from mxdetection_tpu_torch.utils.convert import flax_to_state_dict, load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_detector_fixtures as det_fx  # noqa: E402
import test_train_fixtures as train_fx  # noqa: E402
from test_torch_port_dp import DP_OVERRIDES, dp_batch  # noqa: E402
from test_torch_port_train import _grad_norm, jax_draws, one_torch_thread  # noqa: E402,F401

SYNC = "multihost_dp_faster_rcnn_v5p16"


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_rel_close(got, ref, rtol):
    got, ref = N(got), N(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def norm_case(jmodule, tmodule, dtype, c=64, seed=0):
    """The flax norm and the port's on the same seeded NHWC input, its
    variables randomised: (x, the cotangent g, the variables, and the
    gaps between the two in the outputs, dx, parameter grads and batch
    statistics, each over the largest reference value)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 6, 7, c) * 1.5 + 0.7).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    variables = jax.device_get(jmodule.init(jax.random.PRNGKey(seed), xj))
    variables = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), variables)

    def f(x_, params):
        return jmodule.apply({**variables, "params": params}, x_, mutable=["batch_stats"])

    y_ref, mutated = f(xj, variables["params"])
    _, vjp = jax.vjp(lambda x_, p: f(x_, p)[0], xj, variables["params"])
    dx_ref, dp_ref = vjp(gj)
    ref_stats = flax_to_state_dict({"batch_stats": jax.device_get(mutated.get("batch_stats", {}))})

    tmodule.load_state_dict(flax_to_state_dict(variables), strict=True)
    xt = T(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2).requires_grad_()
    y = tmodule(xt)
    (y.float() * T(g).to(y.dtype).float().permute(0, 3, 1, 2)).sum().backward()
    assert y.dtype == xt.dtype
    ref_dp = flax_to_state_dict({"params": jax.device_get(dp_ref)})
    params, buffers = dict(tmodule.named_parameters()), dict(tmodule.named_buffers())
    gaps = {"out": rel_gap(y.permute(0, 2, 3, 1), y_ref),
            "dx": rel_gap(xt.grad.permute(0, 2, 3, 1), dx_ref),
            "dparams": max(rel_gap(params[k].grad, v) for k, v in ref_dp.items()),
            "stats": max((rel_gap(buffers[k], v) for k, v in ref_stats.items()), default=0.0)}
    return x, g, variables, gaps


def rel_gap(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = N(got), N(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def assert_gaps(gaps: dict, bounds: dict) -> None:
    assert all(gaps[k] <= bounds[k] for k in gaps), (gaps, bounds)


SYNC_BN_BOUNDS = {
    "float32": {"out": 4e-7, "dx": 4e-7, "dparams": 8e-7, "stats": 2e-7, "eval": 3e-7},
    "bfloat16": {"out": 8e-3, "dx": 8e-3, "dparams": 5e-2, "stats": 3e-7, "eval": 8e-3,
                 "dparams_exact": 5e-3}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_batchnorm_matches_flax(dtype):
    """World size 1 (no process group) against the flax ``SyncBatchNorm``
    outside a mapped context (its ``NameError`` fallback): the output, dx,
    dgamma and dbeta (``jax.vjp``) and the running statistics after one
    call; then eval mode against ``use_running_average=True``.

    Measured gaps, of the largest value: f32 output 1.7e-7, dx 1.6e-7,
    dgamma/dbeta 3.6e-7, running statistics 8.4e-8, eval output 1.1e-7;
    bf16 output and eval output 0, dx 3.6e-3, running statistics 1.5e-7,
    dgamma/dbeta 2.6e-2: the flax layer sums them in bf16, the port in f32
    before one rounding, so the port is held besides within 5e-3 of the
    exact (f64) gradient of the same bf16 values (measured 2.3e-3). Bounds
    are about twice the gaps, and one bf16 rounding (8e-3) where the gap
    is 0."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    bn = tlayers.SyncBatchNorm(64)
    x, g, variables, gaps = norm_case(jlayers.SyncBatchNorm(dtype=jdt), bn, dtype)
    assert bn.gamma.dtype == torch.float32 and bn.mean.dtype == torch.float32
    assert isinstance(bn.gamma, torch.nn.Parameter) and "mean" in dict(bn.named_buffers())

    bn.load_state_dict(flax_to_state_dict(variables))
    bn.eval()
    ref = jlayers.SyncBatchNorm(dtype=jdt, use_running_average=True).apply(
        variables, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = bn(T(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
    gaps["eval"] = rel_gap(got.permute(0, 2, 3, 1), ref)
    if dtype == "bfloat16":
        xd, gd = (T(a).to(torch.bfloat16).double().permute(0, 3, 1, 2) for a in (x, g))
        gamma, beta = (T(variables["params"][k]).double().requires_grad_()
                       for k in ("gamma", "beta"))
        mean = xd.mean((0, 2, 3))
        scale = gamma * torch.rsqrt(xd.square().mean((0, 2, 3)) - mean.square() + 1e-5)
        bias = beta - mean * scale
        ((xd * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)) * gd).sum().backward()
        gaps["dparams_exact"] = max(rel_gap(bn.gamma.grad, gamma.grad),
                                    rel_gap(bn.beta.grad, beta.grad))
    assert_gaps(gaps, SYNC_BN_BOUNDS[dtype])


@pytest.mark.parametrize("kind", ["bn", "gn"])
def test_bn_and_group_norm_match_flax(kind):
    """``make_norm("bn")`` (SyncBN that never averages over replicas) and
    ``make_norm("gn")`` (GroupNorm(32), eps 1e-5, f32 parameters, flax's
    ``GroupNorm_0/scale|bias`` converted to ``gamma|beta``) against the
    flax ``make_norm`` of the same kind, in f32, with SyncBN's f32 bounds.
    Measured gaps: "bn" those of SyncBN; GroupNorm output 2.1e-7 of its
    largest value, dx 2.1e-7, dgamma/dbeta 2.9e-7."""
    tmodule = tlayers.make_norm(kind)(64)
    *_, gaps = norm_case(jlayers.make_norm(kind, dtype=jnp.float32, train=True)(), tmodule,
                         "float32")
    assert_gaps(gaps, SYNC_BN_BOUNDS["float32"])
    assert all(p.dtype == torch.float32 for p in tmodule.parameters())
    if kind == "bn":
        assert not tmodule.sync
    with pytest.raises(ValueError, match="unknown norm"):
        tlayers.make_norm("batch_norm")


# ---------------------------------------------------------------- the fixtures


@pytest.fixture(scope="module")
def sync_variables():
    """The JAX ``PRNGKey(7)`` variables of the shrunk SyncBN config, as
    numpy: the same tree at both fixtures' input shapes."""
    jcfg = train_fx.shrink(jax_load_config(os.path.join(REPO, f"configs/{SYNC}.py")))
    bundle = jax_build_detector(jcfg)
    tb = train_fx.synthetic_batch(jcfg)
    return tb, jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(7), tb))


def test_sync_bn_detector_reproduces_jax_fixture(sync_variables):
    """Converted ``PRNGKey(7)`` variables reproduce
    ``detector_multihost_dp_faster_rcnn_v5p16.npz`` (read only) in eval
    mode, where SyncBN reads its running statistics, with the Faster
    detector fixture's bounds (scores, labels, valid 1e-4; boxes 0.05 px).
    The eval-mode model keeps the norms' parameters in f32 in a bf16 model."""
    _, variables = sync_variables
    cfg = det_fx.shrink(load_config(SYNC))
    model = load_flax_variables(build_detector(cfg, device="cpu"), variables)
    assert isinstance(model.backbone.layer1_block0.bn1, tlayers.SyncBatchNorm)
    images = np.asarray(det_fx.synthetic_image()[None] / 255.0, np.float32)
    im_info = np.asarray([[det_fx.HW[0], det_fx.HW[1], 1.0]], np.float32)
    dets = rcnn_postprocess(model.forward_test(T(images), T(im_info)), cfg, det_fx.HW,
                            T(im_info))
    ref = np.load(os.path.join(REPO, f"tests/fixtures/detector_{SYNC}.npz"))
    v = N(dets["valid"][0])
    got = {"boxes": N(dets["boxes"][0]) * v[:, None], "scores": N(dets["scores"][0]) * v,
           "labels": N(dets["labels"][0]) * v, "valid": v.astype(np.int32)}
    for k in ("scores", "labels", "valid"):
        np.testing.assert_allclose(got[k].astype(np.float64), ref[k].astype(np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=0.05)
    assert v.sum() == 20

    bf16 = build_detector(load_config(SYNC), device="cpu")
    bn = bf16.backbone.layer2_block0.bn3
    assert bf16.backbone.layer2_block0.conv3.weight.dtype == torch.bfloat16
    assert bn.gamma.dtype == bn.beta.dtype == bn.mean.dtype == bn.var.dtype == torch.float32


def test_sync_bn_train_step_reproduces_jax_fixture(sync_variables):
    """From converted ``PRNGKey(7)`` params (SyncBN's gamma/beta are
    parameters), ``test_train_fixtures``'s batch and the JAX ``PRNGKey(13)``
    draws, one train-mode forward + backward (batch statistics over the
    two images) reproduces ``trainstep_multihost_dp_faster_rcnn_v5p16.npz``.

    Measured gaps (one torch thread, ``one_torch_thread``): the loss 4.1e-6
    relative, the loss terms up to 1.04e-4 (``loss_rcnn_reg0``, 0.0606),
    the global grad norm 7.4e-4 and the backbone's 1.14e-3. Wider than the
    Faster fixture's (2.2e-5), though SyncBN alone agrees within 3.6e-7 on
    one input (above), because train-mode statistics pass the f32
    summation-order differences of every conv on from layer to layer,
    where frozen statistics do not; the grad norms' gaps move with the
    number of threads that sum them. Bounds about twice the gaps: 2.5e-4
    on the losses, 2.5e-3 on the grad norms; the discrete metrics must be
    exact."""
    tb, variables = sync_variables
    tcfg = train_fx.shrink(load_config(SYNC))
    model = load_flax_variables(build_detector(tcfg, device="cpu", train=True), variables)
    ttb = {k: T(v) for k, v in tb.items()}
    draws = jax_draws(jax.random.PRNGKey(13))
    loss, metrics = rcnn_loss(model.forward_train(ttb, draws), ttb, draws, tcfg)
    loss.backward()
    got = {"loss": float(loss.detach()), "grad_norm": _grad_norm(model.parameters())}
    got.update({f"metric_{k}": float(v.detach()) for k, v in metrics.items()})
    for mod in ("backbone", "fpn", "rpn", "bbox_head0"):
        got[f"gnorm_{mod}"] = _grad_norm(getattr(model, mod).parameters())
    ref = np.load(os.path.join(REPO, f"tests/fixtures/trainstep_{SYNC}.npz"))
    assert set(got) == set(ref.files)
    for k in ref.files:
        r = float(ref[k])
        if k in ("metric_num_pos_rois", "metric_rcnn_acc0"):
            assert got[k] == r, k
        else:
            assert abs(got[k] - r) <= (2.5e-3 if "norm" in k else 2.5e-4) * abs(r), (k, got[k], r)
    assert model.backbone.stem_bn.gamma.grad.abs().max() > 0  # every stage trains
    stem = model.backbone.stem_bn
    assert float(stem.mean.abs().max()) > 0 and float((stem.var - 1).abs().max()) > 0


# ---------------------------------------------------------------- remat


def test_remat_matches_and_updates_running_stats_once():
    """``remat=True`` recomputes each bottleneck in the backward (every
    SyncBN runs its forward twice) and gives the same outputs and
    gradients as ``remat=False`` within 1e-6 of the largest value, and the
    running statistics of a single forward: they move once a step."""
    gen = torch.Generator().manual_seed(3)
    once = ResNet(50, norm_kind="sync_bn", frozen_stages=-1)
    once.reset_parameters(gen)
    state = {k: v.clone() for k, v in once.state_dict().items()}
    images = torch.randn(2, 64, 96, 3, generator=gen)
    with torch.no_grad():
        cots = [torch.randn(o.shape, generator=gen) for o in once(images)]

    runs = {}
    for remat in (False, True):
        net = ResNet(50, norm_kind="sync_bn", frozen_stages=-1, remat=remat)
        net.load_state_dict(state)
        calls = []
        for m in net.modules():
            if isinstance(m, tlayers.SyncBatchNorm):
                m.register_forward_hook(lambda *_: calls.append(1))
        outs = net(images)
        sum((o * c).sum() for o, c in zip(outs, cots)).backward()
        runs[remat] = (outs, {k: p.grad for k, p in net.named_parameters()},
                       {k: v for k, v in net.state_dict().items() if k.endswith((".mean", ".var"))},
                       len(calls))
    n_norms = sum(isinstance(m, tlayers.SyncBatchNorm) for m in once.modules())
    assert runs[False][3] == n_norms and runs[True][3] == 2 * n_norms - 1  # the stem's once
    for a, b in zip(runs[False][0], runs[True][0]):
        assert_rel_close(b, a, 1e-6)
    for k, g in runs[False][1].items():
        assert_rel_close(runs[True][1][k], g, 1e-6)
    ref_stats = {k: v for k, v in once.state_dict().items() if k.endswith((".mean", ".var"))}
    for k, v in ref_stats.items():
        torch.testing.assert_close(runs[True][2][k], v, rtol=0, atol=0)
        torch.testing.assert_close(runs[False][2][k], v, rtol=0, atol=0)
    assert float(runs[True][2]["layer4_block2.bn3.mean"].abs().max()) > 0


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_round_trip(tmp_path):
    """Save after step 1, run step 2; a fresh ``Trainer`` (other weights)
    restored from the checkpoint runs step 2 bit-identically: the weights,
    SyncBN's running statistics, the momentum traces, the step count and
    the draw generator all come back. ``max_to_keep`` prunes the oldest
    checkpoints, ``latest_step`` names the newest, and a saved step is
    written again only with ``force``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU backward sums in another order on more threads
    try:
        round_trip(tmp_path)
    finally:
        torch.set_num_threads(threads)


def round_trip(tmp_path):
    cfg = load_config(SYNC, DP_OVERRIDES)
    batch = dp_batch(np.random.RandomState(4), 1)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert ckpt.latest_step() is None
    a = Trainer(cfg, device="cpu", seed=0)
    a.run_step(batch)
    assert ckpt.save(a) and ckpt.latest_step() == 1
    ref = {k: float(v) for k, v in a.run_step(batch).items()}

    b = Trainer(cfg, device="cpu", seed=1)
    assert ckpt.restore(b) == 1 and b.optimizer.count == 1
    got = {k: float(v) for k, v in b.run_step(batch).items()}
    assert got == ref
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(w, v, rtol=0, atol=0, msg=k)
    for m, n in zip(a.optimizer.trace, b.optimizer.trace):
        torch.testing.assert_close(n, m, rtol=0, atol=0)

    assert ckpt.save(a) and not ckpt.save(b) and ckpt.save(b, force=True)
    a.run_step(batch)
    assert ckpt.save(a)
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert sorted(os.listdir(ckpt.directory)) == ["step_2.pt", "step_3.pt"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(b)
