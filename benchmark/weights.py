"""Seeded weights, made on the card by the benchmark and handed to both the
program and the reference.

The recipe (a configuration file's ``weights``) follows the initialisers
the zoo configs name (he normal convs, xavier FPN and fc layers, normal
RPN and predictors, FrozenBN at identity), with three deliberate changes
that make seeded weights exercise what trained ones do:
- each residual block's last FrozenBN gamma is 1/sqrt(blocks), so the
  activations stay bounded through the network (the port's own recipe,
  ``ResNet.reset_parameters``);
- the class predictor's std is ``cls_std`` (larger than 0.01), so the
  scores spread past the 0.05 test threshold and the postprocess has
  detections to sort and suppress;
- every deformable layer's offset conv gets normal noise scaled by
  1 / (sqrt(9 Cin) * RMS of the layer's input), so its offsets have a std
  of about ``offset_std_cells`` cells and K5-K7 sample off the grid. The RMS
  is measured layer by layer in one f32 forward pass of the reference over
  ``calibration_images`` images of the pool (the recipe of ``tools/common.py
  ::seed_offset_convs``, on the reference instead of the program).

Every draw comes from one ``torch.Generator`` on the card, a few large
calls a run: one a kind, sliced leaf by leaf. The names, shapes and kinds,
and each kind's law, are the detector family's (``param_specs``,
``weight_laws`` of ``benchmark/families/<family>.py``); a kind ``offset``
stays zero until ``calibrate_offsets``.
"""

from __future__ import annotations

import math

import torch

TRUNC = 2.0  # the he normal's truncation, in stds


def _trunc_normal(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` standard normals truncated to [-2, 2], by the inverse CDF."""
    lo, hi = (1 + math.erf(-TRUNC / math.sqrt(2))) / 2, (1 + math.erf(TRUNC / math.sqrt(2))) / 2
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * (hi - lo) + lo
    return (math.sqrt(2) * torch.erfinv(2 * u - 1)).float()


def _fans(shape) -> tuple:
    rf = 1
    for s in shape[2:]:
        rf *= s
    return shape[1] * rf, shape[0] * rf


def make_weights(specs: list, laws: dict, recipe: dict, seed: int, device) -> tuple:
    """The weights of ``specs`` ([(name, shape, init kind)], a family's
    ``param_specs``), each kind drawn by its law in ``laws`` (a family's
    ``weight_laws``: ``he_normal``, ``xavier_uniform``, ``normal`` with the
    std under the recipe's key, ``constant``; a kind without a law is zero)
    -> ({name: f32 tensor on ``device``}, the generator, left where the
    offset noise is drawn next)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    out = {}
    # one draw a kind, in a fixed order
    by_kind: dict = {}
    for name, shape, kind in specs:
        by_kind.setdefault(kind, []).append((name, shape))
    for kind in sorted(by_kind):
        items = by_kind[kind]
        law, arg = laws.get(kind, ("zero", None))
        total = sum(math.prod(s) for _, s in items)
        if law == "he_normal":
            flat = _trunc_normal(total, gen, device)
        elif law == "xavier_uniform":
            flat = torch.rand(total, generator=gen, device=device) * 2 - 1
        elif law == "normal":
            flat = torch.randn(total, generator=gen, device=device)
        elif law in ("constant", "zero"):
            flat = None
        else:
            raise ValueError(f"init kind {kind!r}: unknown law {law!r}")
        i = 0
        for name, shape in items:
            n = math.prod(shape)
            if law == "he_normal":
                t = flat[i:i + n] * (math.sqrt(2.0 / _fans(shape)[0]) / 0.87962566103423978)
            elif law == "xavier_uniform":
                fi, fo = _fans(shape)
                t = flat[i:i + n] * math.sqrt(6.0 / (fi + fo))
            elif law == "normal":
                t = flat[i:i + n] * recipe[arg]
            elif law == "constant":
                t = torch.full((n,), arg, device=device)
            else:
                t = torch.zeros(n, device=device)
            out[name] = t.reshape(shape).contiguous()
            i += n
    return out, gen


@torch.no_grad()
def calibrate_offsets(W: dict, names: list, recipe: dict, forward, gen: torch.Generator) -> None:
    """Set every offset conv's weight of ``names`` (zero until now) from one
    f32 forward pass of the reference, ``forward(on_offset)`` (a family's
    ``calibration_forward``), which calls ``on_offset(name, x)`` with each
    offset conv's weight name and its layer's input."""
    if not names:
        return
    total = sum(W[n].numel() for n in names)
    noise = torch.randn(total, generator=gen, device=W[names[0]].device)
    pos = {"i": 0}

    def on_offset(name, x):
        w = W[name]
        rms = x.float().pow(2).mean().sqrt()
        n = w.numel()
        w.copy_(noise[pos["i"]:pos["i"] + n].reshape(w.shape)
                * (recipe["offset_std_cells"] / (rms * math.sqrt(9 * w.shape[1]))))
        pos["i"] += n

    forward(on_offset)
