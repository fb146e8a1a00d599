"""Port parity, ``backbone.remat`` over the deformable convs: a Cascade
R-CNN training step at the small size of ``test_torch_port_cascade_train.py``
(``shrink``: R50, DCN in stage 4, 256x320, f32) with every bottleneck
recomputed in the backward (``torch.utils.checkpoint``), against the same
step without, on the CPU.

The recompute runs each DCN layer's ``mxdet::deform_conv2d`` forward a second
time (K5/K5b on the card, whose launches double; the plain version here).
The remat step is also held against the JAX step with ``backbone.remat``
(``nn.remat(Bottleneck)``), run live at the bounds of
``test_torch_port_cascade_train.py``'s live test. SyncBN's remat is
``test_torch_port_syncbn.py``'s.
"""

import os
import sys

import numpy as np
import torch

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.ops.matching import TorchDraws
from mxdetection_tpu_torch.tools.common import dcn_layers
from mxdetection_tpu_torch.train.trainer import Trainer

from test_torch_port_cascade_train import (  # noqa: F401  (fixtures)
    assert_live_steps_close, cascade_train, default_torch_threads, live_steps)
from test_torch_port_dcn import CASCADE
from test_torch_port_train import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_train_fixtures import shrink  # noqa: E402


def remat_batch() -> dict:
    """Two uint8 240x300 canvases with three gt boxes each, one flipped."""
    rng = np.random.RandomState(4)
    gt = np.zeros((2, 8, 4), np.float32)
    gt[:, :3] = [[20.0, 30.0, 150.0, 140.0], [100.0, 60.0, 280.0, 220.0], [5, 5, 60, 90]]
    valid = np.zeros((2, 8), bool)
    valid[:, :3] = True
    return {"raw": rng.randint(0, 256, (2, 240, 300, 3)).astype(np.uint8),
            "hw": np.asarray([[240.0, 300.0], [200.0, 300.0]], np.float32),
            "flip": np.asarray([False, True]), "gt_boxes": gt,
            "gt_labels": np.tile(np.asarray([[1, 7, 30, 0, 0, 0, 0, 0]], np.int32), (2, 1)),
            "gt_valid": valid}


def test_remat_recomputes_the_deformable_convs_and_keeps_the_step():
    """With ``backbone.remat`` the step's metrics and every parameter's
    gradient are those of the plain step within 1e-5 relative (of the
    largest value of each gradient); each DCN layer runs its forward twice,
    the plain step once. Cascade's norms are FrozenBN: their statistics
    stay as loaded in both steps."""
    cfg = shrink(load_config(CASCADE))
    model = build_detector(cfg, device="cpu", seed=0, train=True)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():  # zero in the JAX init, which makes each DCN a plain conv
        for m in dcn_layers(model):
            m.offset_conv.weight.copy_(torch.randn(m.offset_conv.weight.shape, generator=gen)
                                       * 1e-2)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = remat_batch()

    runs = {}
    for remat in (False, True):
        rcfg = cfg.override(**{"backbone.remat": remat})
        net = build_detector(rcfg, device="cpu", train=True)
        net.load_state_dict(state)
        calls = []
        for m in dcn_layers(net):
            m.register_forward_hook(lambda *_: calls.append(1))
        metrics = Trainer(rcfg, net, device="cpu").run_step(
            batch, draws=TorchDraws(torch.Generator().manual_seed(8)))
        runs[remat] = ({k: float(v) for k, v in metrics.items()},
                       {k: p.grad for k, p in net.named_parameters() if p.grad is not None},
                       {k: v for k, v in net.state_dict().items() if k.endswith((".mean", ".var"))},
                       len(calls))
    (ref, ref_grads, ref_stats, n_plain), (got, grads, stats, n_remat) = runs[False], runs[True]
    n_dcn = len(dcn_layers(model))
    assert n_dcn == 3 and n_plain == n_dcn and n_remat == 2 * n_dcn
    assert set(got) == set(ref) and ref["num_pos_rois"] > 0
    for k, r in ref.items():
        assert abs(got[k] - r) <= 1e-5 * max(abs(r), 1e-12), (k, got[k], r)
    assert set(grads) == set(ref_grads)
    for k, g in ref_grads.items():
        assert float((grads[k] - g).abs().max()) <= 1e-5 * float(g.abs().max()), k
    assert any(float(g.abs().max()) > 0 for k, g in ref_grads.items() if ".offset_conv." in k)
    assert stats.keys() == ref_stats.keys() and stats
    for k, v in ref_stats.items():
        assert torch.equal(stats[k], state[k]) and torch.equal(v, state[k]), k


def test_remat_step_matches_the_live_jax_remat_step(cascade_train, default_torch_threads):
    """The port's step with ``backbone.remat`` against ``value_and_grad`` of
    the JAX step with ``backbone.remat``, from the same converted params,
    batch, draws and noisy offset conv (``live_steps``): losses within 6e-5
    relative, per-module grad norms within 1.2e-3, the noisy offset conv's
    gradient within 4e-3 of its largest entry, discrete metrics exact."""
    ref, ref_off, model, got = live_steps(cascade_train, **{"backbone.remat": True})
    assert model.backbone.remat and model.training
    assert_live_steps_close(ref, ref_off, model, got)
