"""The FrozenBN epilogue operator, ``mxdet::frozen_bn_act``
(``mxdetection_tpu_torch/ops/norm_act.py``, ``ops/library.py``), on the CPU.

- Its plain version, which the CPU runs and the card's kernel
  (``csrc/norm_act.cu``) must equal, is the modules' eager op sequence bit
  for bit, forward and backward, in f32 and bf16: at the stem, an identity
  block, a projection block and a deformable block.
- SyncBN and GroupNorm blocks never call it.
- Its shape function keeps x's shape, dtype and channels_last strides, so a
  ``torch.export`` graph holds one node a call; ``opcheck`` passes.
- ``norm_act.fused`` counts 49 calls an R50 forward (the stem, then three a
  block) and 100 an R101 forward, with no FrozenBN module run outside the
  operator; remat recomputes through it with the same gradients.
"""

import os
import sys

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_train import one_torch_thread  # noqa: E402,F401  (autouse)

from mxdetection_tpu_torch.models.backbones.resnet import Bottleneck, ResNet
from mxdetection_tpu_torch.models.layers import (FrozenBatchNorm, GroupNorm, SyncBatchNorm,
                                                 conv)
from mxdetection_tpu_torch.ops import library
from mxdetection_tpu_torch.ops.norm_act import frozen_bn_act_plain
from mxdetection_tpu_torch.utils.profiling import Recorder, annotate

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def seeded_bns(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Every FrozenBN's statistics and affine drawn: scales of both signs."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.gamma.shape[0]
                m.gamma.copy_(torch.randn(c, generator=gen))
                m.beta.copy_(torch.randn(c, generator=gen))
                m.mean.copy_(torch.randn(c, generator=gen) * 0.5)
                m.var.copy_(torch.rand(c, generator=gen) + 0.5)


def block(kind: str, dtype) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(0)
    if kind == "stem":
        m = torch.nn.ModuleDict({"conv": conv(3, 16, 7, 2), "bn": FrozenBatchNorm(16)})
    else:
        projection = kind == "projection"
        m = Bottleneck(32 if projection else 64, 16, stride=2 if projection else 1,
                       use_dcn=kind == "dcn")
    for p in m.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if p.dim() > 1 else 0.5))
    seeded_bns(m, gen)
    return m.to(dtype)


def eager(m: torch.nn.Module, kind: str, x: torch.Tensor) -> torch.Tensor:
    """The modules' op sequence, as the backbone ran it before the operator."""
    if kind == "stem":
        return F.relu(m["bn"](m["conv"](x)))
    out = F.relu(m.bn1(m.conv1(x)))
    out = F.relu(m.bn2(m.conv2(out)))
    out = m.bn3(m.conv3(out))
    residual = x if m.downsample_conv is None else m.downsample_bn(m.downsample_conv(x))
    return F.relu(out + residual)


def fused(m: torch.nn.Module, kind: str, x: torch.Tensor) -> torch.Tensor:
    return m["bn"].act(m["conv"](x)) if kind == "stem" else m(x)


def outputs_and_grads(fn, m, x, g):
    x = x.detach().clone().requires_grad_()
    for p in m.parameters():
        p.grad = None
    y = fn(x)
    y.backward(g)
    return [y.detach(), x.grad] + [p.grad for p in m.parameters()]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["stem", "identity", "projection", "dcn"])
def test_operator_is_the_eager_sequence(kind, dtype):
    """The block through the operator against the modules' op sequence:
    output, input gradient and every weight gradient equal bit for bit."""
    dt = DTYPES[dtype]
    m = block(kind, dt)
    gen = torch.Generator().manual_seed(1)
    cin = {"stem": 3, "identity": 64, "projection": 32, "dcn": 64}[kind]
    x = torch.randn(2, cin, 12, 14, generator=gen).to(dt).contiguous(
        memory_format=torch.channels_last)
    if kind == "dcn":  # offsets of about a cell, so the sampling is not a plain conv
        with torch.no_grad():
            m.conv2.offset_conv.weight.copy_(
                torch.randn(m.conv2.offset_conv.weight.shape, generator=gen) * 0.05)
    y = eager(m, kind, x)
    g = torch.randn(y.shape, generator=gen).to(dt).contiguous(memory_format=torch.channels_last)
    ref = outputs_and_grads(lambda t: eager(m, kind, t), m, x, g)
    got = outputs_and_grads(lambda t: fused(m, kind, t), m, x, g)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    assert got[0].dtype == dt
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("norm", ["sync_bn", "bn", "gn"])
def test_other_norms_never_call_the_operator(norm, monkeypatch):
    """A SyncBN, train-mode BN or GroupNorm ResNet runs the modules' op
    sequence: the operator is never called, nothing is counted."""
    def refuse(*args):
        raise AssertionError("mxdet::frozen_bn_act called")

    monkeypatch.setattr(library, "frozen_bn_act", refuse)
    m = ResNet(50, norm_kind=norm)
    assert not any(isinstance(x, FrozenBatchNorm) for x in m.modules())
    assert any(isinstance(x, (SyncBatchNorm, GroupNorm)) for x in m.modules())
    m.reset_parameters(torch.Generator().manual_seed(0))
    with Recorder() as rec, annotate("forward"):
        m.eval()(torch.randn(1, 32, 32, 3))
    assert rec.items()[0]["forward"]["counters"] == {}


OP_CASES = {  # (residual, residual BN)
    "a": (False, False), "b_identity": (True, False), "b_downsample": (True, True)}


def op_args(case: str, dtype=torch.float32):
    residual, res_bn = OP_CASES[case]
    gen = torch.Generator().manual_seed(3)

    def nhwc():
        return torch.randn(2, 16, 5, 7, generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)

    def chans():
        return torch.randn(16, generator=gen).to(dtype)

    return (nhwc(), chans(), chans(), nhwc() if residual else None,
            chans() if res_bn else None, chans() if res_bn else None)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_operator_cpu_is_plain_and_passes_opcheck(case):
    """On CPU tensors the operator is its plain version bit for bit, keeps
    channels_last, and ``opcheck`` passes (schema, shape function against
    the CPU implementation, autograd registration, tracing)."""
    args = op_args(case)
    got = library.frozen_bn_act(*args)
    torch.testing.assert_close(got, frozen_bn_act_plain(*args), rtol=0, atol=0)
    assert got.stride() == args[0].stride()
    args = tuple(a.requires_grad_() if i in (0, 3) and a is not None else a
                 for i, a in enumerate(args))
    torch.library.opcheck(library.frozen_bn_act, args)


class StemAndBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = block("stem", torch.float32)
        self.block = block("identity", torch.float32)
        self.widen = conv(16, 64, 1)

    def forward(self, x):  # x (B, H, W, 3) NHWC
        y = fused(self.stem, "stem", x.permute(0, 3, 1, 2))
        return self.block(self.widen(y)).permute(0, 2, 3, 1)


def test_export_holds_one_node_a_call():
    """``torch.export`` of a stem and an identity block traces the operator
    through its shape function: four nodes (the stem, bn1, bn2, bn3 with the
    residual), each with its input's shape, dtype and channels_last strides,
    and the exported program gives the eager bits."""
    m = StemAndBlock().eval()
    x = torch.randn(2, 24, 28, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        program = torch.export.export(m, (x,))
        eager_out = m(x)
        exported_out = program.module()(x)
    nodes = [n for n in program.graph.nodes
             if n.op == "call_function" and str(n.target) == "mxdet.frozen_bn_act.default"]
    assert len(nodes) == 4
    for n in nodes:
        val, inp = n.meta["val"], n.args[0].meta["val"]
        assert val.shape == inp.shape and val.dtype == inp.dtype
        assert val.stride() == inp.stride()
        assert val.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(exported_out, eager_out, rtol=0, atol=0)


@pytest.mark.parametrize("depth,calls", [(50, 49), (101, 100)])
def test_counter_counts_every_call(depth, calls):
    """``norm_act.fused`` under the open span: the stem and three a block,
    49 an R50 forward, 100 an R101 forward; no FrozenBN module runs
    outside the operator."""
    m = ResNet(depth)
    m.reset_parameters(torch.Generator().manual_seed(0))
    outside = []
    for bn in m.modules():
        if isinstance(bn, FrozenBatchNorm):
            bn.register_forward_hook(lambda *_: outside.append(1))
    with Recorder() as rec, annotate("infer.backbone"):
        m.eval()(torch.randn(1, 32, 32, 3))
    assert rec.items()[0]["infer.backbone"]["counters"] == {"norm_act.fused": calls}
    assert not outside


def test_remat_recomputes_through_the_operator():
    """``backbone.remat`` in training: the checkpointed blocks of the
    trained stages (2-4, 13 of them) run the operator again in the backward,
    49 + 39 calls a step, and every gradient equals the step's without remat
    bit for bit."""
    grads, counts = [], []
    for remat in (False, True):
        m = ResNet(50, remat=remat)
        gen = torch.Generator().manual_seed(0)
        m.reset_parameters(gen)
        seeded_bns(m, gen)
        m.train()
        with Recorder() as rec, annotate("train.step"):
            outs = m(torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(5)))
            sum((o.float() ** 2).sum() for o in outs).backward()
        counts.append(rec.items()[0]["train.step"]["counters"]["norm_act.fused"])
        grads.append([p.grad for p in m.parameters() if p.grad is not None])
    assert counts == [49, 49 + 39]
    assert len(grads[0]) == len(grads[1]) > 0
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
