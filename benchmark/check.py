"""What decides ``correct``: the f32 reference judges what the timed path
produced. Inference is judged by the cell's detector family
(``benchmark/families/<family>.py::judge_infer``, whose docstring names its
numbers); training here, over the family's reference step (``train_step``).

Training (``judge_train``): the reference follows two runs of three steps
from the same weights, optimizer state, batches and random draws: the
set-up's first three steps, from the seeded weights and zero momentum, and
three steps of the measured window from a step the seed picks, from the
program's parameters and momentum cloned on the device just before it. For
each following:
- ``loss_gap``: each step's loss against the reference's, relative;
- ``grad_gap``: the first step's clipped gradient as the optimizer got it
  (its momentum buffer after the step less the decayed weights and the
  decayed momentum before it), leaf by leaf: the gap between the two norms
  over the reference leaf's norm or the median leaf's, whichever is
  larger, the worst leaf;
- ``update_gap``: the parameters' change over the three steps, the same way.
Leaves whose reference gradient is under a thousandth of the median leaf's
(the frozen stages, which only decay) are left out of both leaf numbers.
Each number is the larger of the two followings' (``merge_followings``).
"""

from __future__ import annotations

import math
import statistics

import torch


def leaf_gap(prog: dict, ref: dict, counted: list) -> tuple:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median counted leaf's norm) -> (gap, leaf)."""
    rn = {n: float(ref[n].double().norm()) for n in counted}
    med = statistics.median(rn.values())
    worst, name = 0.0, None
    for n in counted:
        g = abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med, 1e-30)
        if g > worst:
            worst, name = g, n
    return worst, name


def judge_train(fam, m: dict, params0: dict, buffers: dict, steps: list, prec=None,
                images=None, steps_per_epoch: int = 1000, trace0: dict | None = None,
                step0: int = 0) -> dict:
    """The reference's following of three steps (the detector family
    ``fam``'s ``train_step`` and its optimizer): ``steps`` holds each
    step's {batch, draws} and what the family's ``Follow`` kept of it,
    ``params0`` the weights before the first by parameter name, ``trace0``
    the momentum buffers then (zeros by default) and ``step0`` the number of
    steps taken before it (the learning rate's step). It computes in
    ``prec`` over ``images`` (a control or a fault puts it in the program's
    place that way; by default the family's f32 over the whole batch) ->
    {losses, g1 (the first step's clipped gradient), params3 (the
    parameters after the steps)}."""
    o = m["train"]["optim"]
    prec = fam.F32 if prec is None else prec
    lr = fam.warmup_multistep(o, steps_per_epoch)
    params = {n: v.clone() for n, v in params0.items()}
    trace = ({n: torch.zeros_like(v) for n, v in params0.items()} if trace0 is None
             else {n: v.clone() for n, v in trace0.items()})
    losses, g1 = [], None
    for i, st in enumerate(steps):
        loss, grads = fam.train_step(params, buffers, m, st["batch"], st, prec, images)
        clipped = fam.sgd_step(params, grads, trace, lr(step0 + i), o)
        if i == 0:
            g1 = clipped
        losses.append(loss)
    return {"losses": losses, "g1": g1, "params3": params}


def compare_train(ref: dict, prog: dict, params0: dict) -> dict:
    """The numbers of the module's docstring for one following of three
    steps, from two runs of it (``ref`` the f32 reference's, ``prog`` the
    program's or a control's, each {losses, g1, params3}; a program's ``g1``
    is worked out from its momentum buffers by ``program_g1``)."""
    n_steps = min(len(ref["losses"]), len(prog["losses"]))
    loss_gap = max(abs(prog["losses"][i] - ref["losses"][i]) / max(abs(ref["losses"][i]), 1e-30)
                   for i in range(n_steps))
    if any(not math.isfinite(x) for x in prog["losses"]):
        loss_gap = math.inf
    norms = {n: float(g.double().norm()) for n, g in ref["g1"].items()}
    live = sorted(v for v in norms.values() if v > 0)
    med = statistics.median(live)
    counted = [n for n, v in norms.items() if v >= 1e-3 * med]
    grad_gap, grad_leaf = leaf_gap(prog["g1"], ref["g1"], counted)
    d_ref = {n: ref["params3"][n] - params0[n] for n in counted}
    d_prog = {n: prog["params3"][n] - params0[n] for n in counted}
    update_gap, update_leaf = leaf_gap(d_prog, d_ref, counted)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
            "worst_grad_leaf": grad_leaf, "worst_update_leaf": update_leaf,
            "leaves_counted": len(counted), "leaves": len(norms),
            "ref_losses": ref["losses"], "prog_losses": prog["losses"]}


def program_g1(trace1: dict, params0: dict, o: dict, trace0: dict | None = None) -> dict:
    """The first followed step's clipped gradient from the momentum buffers
    before (``trace0``, zeros by default) and after it: m1 = g + wd * p0 +
    momentum * m0."""
    wd, mu = o["weight_decay"], o["momentum"]
    return {n: trace1[n] - wd * params0[n] - (0.0 if trace0 is None else mu * trace0[n])
            for n in trace1}


GAPS = ("loss_gap", "grad_gap", "update_gap")


def judge_followings(fam, m: dict, extra: dict, prec, images=None,
                     steps_per_epoch: int = 1000) -> dict:
    """A control or a fault put in the program's place over a run's
    followings (``extra`` as ``cell.run_train`` fills it): the family
    ``fam``'s reference in ``prec`` over ``images`` from each following's
    start -> the merged numbers against the f32 reference's."""
    parts = {}
    for name, f in extra["followings"].items():
        got = judge_train(fam, m, f["params0"], extra["buffers"], f["steps"], prec, images,
                          steps_per_epoch, trace0=f["trace0"], step0=f["step0"])
        parts[name] = compare_train(f["ref"], got, f["params0"])
    return merge_followings(parts)


def not_followed(losses: list) -> dict:
    """``compare_train``'s numbers for a following the reference could not
    follow (the program's steps did not run on the whole batch): 1 each."""
    return {**{k: 1.0 for k in GAPS}, "worst_grad_leaf": None, "worst_update_leaf": None,
            "leaves_counted": 0, "leaves": 0, "prog_losses": losses, "ref_losses": []}


def merge_followings(parts: dict) -> dict:
    """{following: ``compare_train``'s numbers} -> each gap the largest of
    the followings', with every following's own beside it (``grad_gap.window``)."""
    out = {k: max(p[k] for p in parts.values()) for k in GAPS}
    for name, p in parts.items():
        out.update({f"{k}.{name}": p[k] for k in GAPS})
        out.update({f"worst_grad_leaf.{name}": p["worst_grad_leaf"],
                    f"worst_update_leaf.{name}": p["worst_update_leaf"],
                    f"losses.{name}": p["prog_losses"], f"ref_losses.{name}": p["ref_losses"]})
    out.update(leaves_counted=max(p["leaves_counted"] for p in parts.values()),
               leaves=max(p["leaves"] for p in parts.values()))
    return out
