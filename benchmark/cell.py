"""One run of one cell: set-up, the measured window, the traced slice, the
check of what the window produced, and the result line.

``run`` is what ``benchmark/run.py`` calls after its look for the card; the
CPU tests call it directly, at tiny sizes, with ``device="cpu"`` (and, to see
``correct`` come out false, with the timed path broken underneath). What
depends on the detector (its weights, what the reference follows, the
check, the marks, the kernels' bounds and the FLOP count) comes from the
cell's family module (``sp["family"]``, ``benchmark/families/<family>.py``).
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import sys
import time

import numpy as np
import torch

from . import check, weights
from . import spec as spec_lib
from .traffic import Pool

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mxdetection_tpu")
STEPS_PER_EPOCH = 7330  # COCO train2017's 117,266 images at 16 a step
FOLLOWED_STEPS = 3      # the training steps the reference follows


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level module names in ``sys.modules`` that a run may not hold,
    compared whole (``mxdetection_tpu_torch`` is not ``mxdetection_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def now() -> float:
    return time.perf_counter()


class Event:
    """A CUDA event on the card; on the CPU (the tests) a host timestamp."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.ev = torch.cuda.Event(enable_timing=True) if self.cuda else None
        self.t = None

    def record(self):
        if self.cuda:
            self.ev.record()
        else:
            self.t = now()
        return self

    def synchronize(self):
        if self.cuda:
            self.ev.synchronize()

    def ms_to(self, other: "Event") -> float:
        return self.ev.elapsed_time(other.ev) if self.cuda else (other.t - self.t) * 1e3


class Marks:
    """CUDA events at the layer boundaries of every item of the window:
    ``mark(name)`` ends the span ``name`` that the previous mark began."""

    def __init__(self, device):
        self.device, self.items, self.cur = device, [], None

    def begin(self):
        self.cur = [("start", Event(self.device).record())]

    def mark(self, name: str):
        if self.cur is not None:
            self.cur.append((name, Event(self.device).record()))

    def end(self, name: str):
        self.mark(name)
        self.items.append(self.cur)
        self.cur = None

    def spans(self) -> dict:
        """{span: [ms of each item]}, summed where a name repeats in an item."""
        out = collections.defaultdict(list)
        for marks in self.items:
            marks[-1][1].synchronize()
            per = collections.defaultdict(float)
            for (_, a), (name, b) in zip(marks, marks[1:]):
                per[name] += a.ms_to(b)
            for name, ms in per.items():
                out[name].append(ms)
        return dict(out)


class Reservoir:
    """A seeded uniform sample of ``k`` items of a stream of unknown length."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, np.random.default_rng(seed), 0, []

    def offer(self, item) -> bool:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
            return True
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j] = item
            return True
        return False


class Draws:
    """The samplers' random draws, from the benchmark's own generator on the
    device; the draws of the steps the reference follows are kept."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed((int(seed) * 2654435761 + 17) % (2 ** 63))
        self.log = None

    def __call__(self, name: str, shape: tuple) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.gen.device)
        if self.log is not None:
            self.log[name] = u
        return u


def set_precision(conf: dict) -> None:
    p = conf["precision"]
    torch.backends.cudnn.allow_tf32 = p["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = p["matmul_allow_tf32"]


def program_config(conf: dict):
    """The program's config of this configuration: its zoo entry with the
    file's overrides, held against the file's ``model`` section, which the
    reference reads."""
    from mxdetection_tpu_torch.config import load_config

    cfg = load_config(conf["zoo"], conf["overrides"])
    got = json.loads(json.dumps(dataclasses.asdict(cfg)))
    if got != conf["model"]:
        diff = sorted(k for k in set(got) | set(conf["model"]) if got.get(k) != conf["model"].get(k))
        raise ValueError(f"the program's config differs from the file's model section in {diff}")
    return cfg


def build_program(cfg, device, train: bool):
    from mxdetection_tpu_torch.models.registry import build_detector

    with torch.device(device):
        return build_detector(cfg, device=device, train=train)


def make_weights(fam, conf: dict, pool: Pool, seed: int, device) -> dict:
    """The seeded weights of the detector family ``fam`` (f32, on the
    device), offsets calibrated."""
    m, recipe = conf["model"], conf["weights"]
    specs = fam.param_specs(m)
    W, gen = weights.make_weights(specs, fam.weight_laws(m), recipe, seed, device)
    n = recipe.get("calibration_images", 1)
    raw, hw = pool.raw[:n].to(device), pool.hw[:n].to(device)
    weights.calibrate_offsets(W, [name for name, _, kind in specs if kind == "offset"], recipe,
                              lambda on_offset: fam.calibration_forward(W, m, raw, hw, on_offset), gen)
    return W


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def device_kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


# ---------------------------------------------------------------- the traced slice


def profile_summary(prof, wall_s: float) -> dict:
    """Device busy seconds (the union of kernel intervals), seconds by
    kernel name and by host op (the device time of what each op launched),
    and the idle gaps between kernels, each named by the innermost host op
    running at its middle."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    kern = [e for e in evs if e.device_type == DeviceType.CUDA]
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    kernels, ops = collections.defaultdict(float), collections.defaultdict(float)
    for e in kern:
        kernels[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    for e in cpu:
        if e.device_time_total > 0:
            ops[e.name] += e.device_time_total * 1e-6
    iv = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, gaps, cur = 0.0, [], None
    for s, e in iv:
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        cover = [e for e in cpu if e.time_range.start <= mid <= e.time_range.end]
        if cover:
            name = min(cover, key=lambda e: e.time_range.end - e.time_range.start).name
        else:  # the host ran Python between ops: name the last op it left
            before = [e for e in cpu if e.time_range.end <= mid]
            name = ("after " + max(before, key=lambda e: e.time_range.end).name) if before else "host"
        named.append([name, (b - a) * 1e-6])
    return {"busy_s": busy * 1e-6, "window_s": wall_s, "kernels": dict(kernels), "ops": dict(ops),
            "gaps": named}


class Slice:
    """``torch.profiler`` over ``n`` further items of the window's loop, run
    after the window closes (so that the profiler's start costs the window
    nothing)."""

    def __init__(self, n: int, device):
        self.n, self.device = n, device
        self.prof, self.t0, self.summary = None, None, None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = now()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = now() - self.t0
        self.prof.__exit__(None, None, None)
        self.summary = profile_summary(self.prof, wall)
        self.prof = None


# ---------------------------------------------------------------- inference


def run_infer(sp: dict, seed: int, seconds: float, trace: bool, device, proc_start: float,
              entry=None) -> dict:
    """Set-up, window and check of an inference cell -> (records, checks)."""
    from mxdetection_tpu_torch.tools.common import infer_batch

    entry = infer_batch if entry is None else entry
    fam, conf, t = sp["family"], sp["config"], sp["traffic"]
    m = conf["model"]
    set_precision(conf)
    cfg = program_config(conf)
    pool = Pool(t, seed, device, pin=device.type == "cuda")
    model = build_program(cfg, device, train=False)
    W = make_weights(fam, conf, pool, seed, device)
    model.load_state_dict(W, strict=True)
    served = {k: v.dtype for k, v in model.state_dict().items()}
    W_ref = {k: W[k].to(served[k]).to("cpu", torch.float32, copy=True) for k in W}
    del W
    dtype = model.compute_dtype
    b, in_flight = t["batch"], t["in_flight"]

    keeper = fam.Keep(model)
    sampler = Reservoir(t["check_batches"], seed + 1)
    marks = slice_ = None
    facts = []

    def submit(k: int) -> dict:
        raw_h, hw_h = pool.infer_batch(k)
        t_sub = now()
        raw = raw_h.to(device, non_blocking=True)
        hw = hw_h.to(device, non_blocking=True)
        if marks is not None:
            marks.begin()
        t0 = now()
        dets, out = entry(model, cfg, raw, hw, dtype)
        host_s = now() - t0
        if marks is not None:
            marks.end("postprocess")
        host = {key: dets[key].to("cpu", non_blocking=device.type == "cuda") for key in fam.DETECTIONS}
        ev = Event(device).record()
        keep = {"k": k, **keeper.take(out, raw.shape[0])}
        if slice_ is not None and slice_.prof is not None:
            facts.append(fam.infer_facts(out))
        return {"t_submit": t_sub, "host_s": host_s, "ev": ev, "host": host, "keep": keep}

    done = []

    def collect(rec: dict, window: bool) -> None:
        rec["ev"].synchronize()
        rec["t_done"] = now()
        if window:
            rec["keep"]["dets"] = rec["host"]
            if not sampler.offer(rec["keep"]):
                rec["keep"] = None
            done.append(rec)
        del rec["ev"], rec["host"]

    q = collections.deque()
    k = 0
    for _ in range(t["warmup_batches"]):  # the window's own loop, untimed
        q.append(submit(k))
        k += 1
        if len(q) >= in_flight:
            collect(q.popleft(), False)
    while q:
        collect(q.popleft(), False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if trace:
        marks = Marks(device)
        hooks = fam.infer_marks(model, marks)
        slice_ = Slice(t["trace_items"], device)

    t_start = now()
    setup_s = t_start - proc_start
    i = 0
    while now() - t_start < seconds or i < max(1, t.get("min_batches", 0)):
        q.append(submit(k))
        k += 1
        i += 1
        if len(q) >= in_flight:
            collect(q.popleft(), True)
    while q:
        collect(q.popleft(), True)
    window_s = done[-1]["t_done"] - t_start
    if trace:  # the traced slice: the window's loop over further batches
        for h in hooks:
            h.remove()
        spans, marks = marks.spans(), None
        slice_.start()
        for j in range(slice_.n):
            q.append(submit(k))
            k += 1
            if len(q) >= in_flight:
                collect(q.popleft(), False)
        while q:
            collect(q.popleft(), False)
        slice_.stop()
    keeper.remove()

    rec = {"mode": "infer", "batch": b, "setup_s": setup_s, "window_s": window_s,
           "items": [{"images": b, "latency_s": r["t_done"] - r["t_submit"], "host_s": r["host_s"]}
                     for r in done],
           "flops_per_item": fam.flops_per_item(m, b, train=False),
           "memory_peak_bytes": memory_peak(device)}
    if trace:
        rec["stages"] = spans
        rec["profile"] = slice_.summary
        rec["profile"]["bounds"] = fam.infer_bounds(m, facts, b)
    lat = sorted(r["t_done"] - r["t_submit"] for r in done)
    log(f"window: {len(done)} batches of {b} in {window_s:.3f} s, median latency "
        f"{lat[len(lat) // 2] * 1e3:.2f} ms; set-up {setup_s:.3f} s")

    samples = [s for s in sampler.kept if s is not None]
    rng = np.random.default_rng(seed + 2)
    for s in samples:
        s["images"] = sorted(rng.choice(b, size=min(b, t["check_images"]), replace=False).tolist())
    del model, facts, done, q, keeper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    W_dev = {k: v.to(device) for k, v in W_ref.items()}
    for s in samples:
        raw, hw = pool.infer_batch(s["k"])
        s["raw"], s["hw"] = raw.to(device), hw.to(device)
    t0 = now()
    numbers = fam.judge_infer(W_dev, m, samples)
    log(f"check: {numbers['images_checked']} images of {len(samples)} batches, "
        f"{numbers['detections_checked']} detections, {now() - t0:.1f} s")
    for why in numbers["not_reproduced_why"]:
        log(f"check: not reproduced: {why}")
    return rec, numbers


# ---------------------------------------------------------------- training


def run_train(sp: dict, seed: int, seconds: float, trace: bool, device, proc_start: float,
              step_fn=None, extra: dict | None = None) -> dict:
    """Set-up (the first steps, which the reference follows), window (three
    of whose steps, from one the seed picks, the reference follows too) and
    check of a training cell -> (records, checks)."""
    from mxdetection_tpu_torch.train.trainer import Trainer

    fam, conf, t = sp["family"], sp["config"], sp["traffic"]
    m = conf["model"]
    set_precision(conf)
    cfg = program_config(conf)
    pool = Pool(t, seed, device, pin=device.type == "cuda")
    model = build_program(cfg, device, train=True)
    W = make_weights(fam, conf, pool, seed, device)
    model.load_state_dict(W, strict=True)
    names = [n for n, _ in model.named_parameters()]
    W_host = {k: v.to("cpu", copy=True) for k, v in W.items()}
    del W
    trainer = Trainer(cfg, model, device=device, steps_per_epoch=STEPS_PER_EPOCH)
    opt = trainer.optimizer
    step = trainer.run_step if step_fn is None else (lambda batch, draws: step_fn(trainer, batch, draws))
    draws = Draws(seed, device)
    b = t["batch"]
    lo, hi = t["follow_window_steps"]
    j0 = int(np.random.default_rng(seed + 3).integers(lo, hi + 1))

    def clone(ts) -> dict:
        return {n: x.detach().clone() for n, x in zip(names, ts)}

    follower = fam.Follow(model, m, b, lambda: draws.log is not None)

    def taken(k: int) -> dict:
        """What the step just run drew and chose, for the reference to follow."""
        f = {"k": k, "draws": draws.log, **follower.take()}
        draws.log = None
        return f

    setup_f = {"steps": [], "step0": 0, "trace0": None,
               "params0": {n: W_host[n] for n in names}}
    losses0 = []
    for s in range(FOLLOWED_STEPS):
        draws.log = {}
        metrics = step(dict(pool.train_batch(s)), draws)
        losses0.append(metrics["loss"])
        setup_f["steps"].append(taken(s))
        if s == 0:
            setup_f["trace1"] = {n: x.to("cpu", copy=True) for n, x in clone(opt.trace).items()}
    setup_f["params3"] = {n: x.to("cpu", copy=True) for n, x in clone(trainer.params).items()}
    setup_f["losses"] = [float(x) for x in losses0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    marks = slice_ = None
    facts = []
    if trace:
        marks = Marks(device)
        loss_fn, opt_step = trainer.loss_fn, opt.step

        def loss_marked(*a, **kw):
            marks.mark("forward")
            r = loss_fn(*a, **kw)
            marks.mark("loss")
            return r

        def step_marked(grads):
            marks.mark("backward")
            return opt_step(grads)

        trainer.loss_fn, opt.step = loss_marked, step_marked
        slice_ = Slice(t["trace_items"], device)

    # the window: steps back to back; from its step j0 the parameters and the
    # momentum are cloned on the device and three steps' draws and choices kept
    window_f = {"steps": []}
    losses, items = [], []
    t_start = now()
    setup_s = t_start - proc_start
    k = FOLLOWED_STEPS
    while now() - t_start < seconds or len(items) < j0 + FOLLOWED_STEPS:
        i = len(items)
        following = j0 <= i < j0 + FOLLOWED_STEPS
        if i == j0:
            window_f.update(params0=clone(trainer.params), trace0=clone(opt.trace), step0=opt.count)
        if following:
            draws.log = {}
        if marks is not None:
            marks.begin()
        t0 = now()
        metrics = step(dict(pool.train_batch(k)), draws)
        host_s = now() - t0
        if marks is not None:
            marks.end("optimizer")
        if following:
            window_f["steps"].append(taken(k))
            if i == j0:
                window_f["trace1"] = clone(opt.trace)
            if i == j0 + FOLLOWED_STEPS - 1:
                window_f["params3"] = clone(trainer.params)
        losses.append(metrics["loss"])
        items.append({"images": b, "host_s": host_s})
        k += 1
    window_losses = torch.stack(losses).float().cpu()
    window_s = now() - t_start
    window_f["losses"] = window_losses[j0:j0 + FOLLOWED_STEPS].tolist()
    follower.remove()
    if trace:  # the traced slice: further steps of the window's loop
        marks.cur = None
        trainer.loss_fn, opt.step = loss_fn, opt_step
        slice_.start()
        for j in range(slice_.n):
            hooks = fam.train_facts(model, facts) if j == 0 else []
            step(dict(pool.train_batch(k)), draws)
            k += 1
            for h in hooks:
                h.remove()
        slice_.stop()

    rec = {"mode": "train", "batch": b, "setup_s": setup_s, "window_s": window_s, "items": items,
           "flops_per_item": fam.flops_per_item(m, b, train=True),
           "memory_peak_bytes": memory_peak(device),
           "failed": int((~torch.isfinite(window_losses)).sum())}
    if trace:
        rec["stages"] = marks.spans()
        rec["profile"] = slice_.summary
        rec["profile"]["bounds"] = fam.train_bounds(m, facts, b, slice_.n)
    log(f"window: {len(items)} steps of {b} in {window_s:.3f} s, steps {j0}-{j0 + FOLLOWED_STEPS - 1} "
        f"of it followed; set-up {setup_s:.3f} s; losses {[round(x, 4) for x in setup_f['losses']]} "
        f"then {window_losses[:3].tolist()}..")

    del trainer, model, opt, metrics, losses, facts
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    followings = {"setup": setup_f, "window": window_f}
    buffers = {n: v.to(device) for n, v in W_host.items() if n not in set(names)}
    o = m["train"]["optim"]

    def on_dev(d):
        return None if d is None else {n: v.to(device) for n, v in d.items()}

    t0 = now()
    parts = {}
    for name, f in followings.items():
        if not all(fam.whole_batch(st, b) for st in f["steps"]):
            log(f"check: the program's {name} steps did not run on the whole batch")
            parts[name] = check.not_followed(f["losses"])
            continue
        f["params0"], f["trace0"] = on_dev(f["params0"]), on_dev(f["trace0"])
        f["steps"] = [{**st, "batch": {key: (v.to(device) if isinstance(v, torch.Tensor) else v)
                                       for key, v in pool.train_batch(st["k"]).items()}}
                      for st in f["steps"]]
        f["ref"] = check.judge_train(fam, m, f["params0"], buffers, f["steps"], trace0=f["trace0"],
                                     step0=f["step0"], steps_per_epoch=STEPS_PER_EPOCH)
        prog = {"losses": f["losses"],
                "g1": check.program_g1(on_dev(f["trace1"]), f["params0"], o, f["trace0"]),
                "params3": on_dev(f["params3"])}
        parts[name] = check.compare_train(f["ref"], prog, f["params0"])
    numbers = check.merge_followings(parts)
    if extra is not None:  # the control's and the faults' readings start from here
        extra.update(followings=followings, buffers=buffers)
    log(f"check: steps {[st['k'] for f in followings.values() for st in f['steps']]} followed in "
        f"{now() - t0:.1f} s; " + "; ".join(
            f"{name}: losses {p['prog_losses']} vs the reference's {p['ref_losses']}, worst leaves "
            f"{p['worst_grad_leaf']}, {p['worst_update_leaf']}" for name, p in parts.items())
        + f"; {numbers['leaves_counted']} of {numbers['leaves']} leaves counted")
    return rec, numbers


# ---------------------------------------------------------------- the run


def limits_check(numbers: dict, limits: dict) -> tuple:
    """-> (correct, {name: {value, limit}}) over the numbers that have a limit."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = float(numbers[name])
        out[name] = {"value": v, "limit": lim}
        ok &= math.isfinite(v) and v <= lim
    return ok, out


def run(sp: dict, seed: int, seconds: float, trace: bool, device, proc_start: float,
        extra: dict | None = None, **faults) -> dict:
    """One run of the cell ``sp`` (``spec.cell``) -> the result line's dict.
    ``extra``, where given, receives every number the check worked out
    (``numbers``) and, in training, what the control starts from."""
    device = torch.device(device)
    mode = sp["traffic"]["mode"]
    if mode == "infer":
        rec, numbers = run_infer(sp, seed, seconds, trace, device, proc_start, **faults)
    else:
        rec, numbers = run_train(sp, seed, seconds, trace, device, proc_start, extra=extra, **faults)
    if extra is not None:
        extra["numbers"] = numbers
    correct, checks = limits_check(numbers, sp["workload"]["limits"])
    if mode == "infer":
        correct &= numbers["images_checked"] > 0
    metrics = {}
    for x in (sp["per_layer"] if trace else sp["end_to_end"]):
        v = spec_lib.reader(x["name"])(rec)
        if v is not None:
            metrics[x["name"]] = {"value": v, "unit": x["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": device_kind(device),
           "count": sp["entry"]["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": len(rec["items"]), "failed": rec.get("failed", 0),
           "metrics": metrics, "device": dev}
    if trace:
        prof = rec["profile"]
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in top], "idle_gaps": prof["gaps"]}
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    out["checks"] = checks
    return out
