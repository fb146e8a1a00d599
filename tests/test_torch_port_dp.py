"""Port parity, data parallelism: ``mxdetection_tpu_torch.parallel`` and the
data-parallel ``Trainer`` on a 2-process gloo group, against one process
and against the JAX ``Trainer`` on a 2-device mesh of the virtual CPU devices.

The parent (pytest) writes the workers' inputs to an ``.npz``, starts two
workers running this file as a script (they import no jax and load no
``conftest.py``; jax, flax, optax and ``mxdetection_tpu`` are blocked in
them), computes the references meanwhile, and compares what the workers
wrote back. One pair of workers runs every check:

- ``SyncBatchNorm`` over halves of x against single-process BN over all of
  x: outputs, running statistics, each rank's dx against the matching slice
  of d(L0 + L1)/dx (the backward of the statistics' all-reduce sums the
  replicas' cotangents, as the transpose of ``pmean``), and dgamma/dbeta
  averaged over the ranks against half of d(L0 + L1)/dgamma;
- ``all_gather_objects``;
- one ``Trainer.run_step`` of the shrunk SyncBN config, one image a rank,
  against the JAX step on a 2-device mesh fed the JAX draws of each replica.
"""

import os
import socket
import subprocess
import sys
import tempfile

if __name__ == "__main__":  # a worker: the port alone, as on the card's machine
    for blocked in ("jax", "flax", "optax", "mxdetection_tpu"):
        sys.modules[blocked] = None

import numpy as np
import pytest
import torch

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.models.layers import SyncBatchNorm, make_norm
from mxdetection_tpu_torch.models.registry import build_detector
from mxdetection_tpu_torch.parallel import mesh
from mxdetection_tpu_torch.parallel.dist import all_gather_objects
from mxdetection_tpu_torch.train.trainer import Trainer

if __name__ != "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_port_train import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC = "multihost_dp_faster_rcnn_v5p16"
# the SyncBN config cut to one image of 100x150 a rank on a 128x160 canvas
DP_OVERRIDES = {
    "data.pad_h": 128, "data.pad_w": 160, "data.scale": 120, "data.max_size": 160,
    "data.max_gt": 4, "backbone.dtype": "float32", "bbox_head.num_samples": 16,
    "rpn.pre_nms_top_n_train": 200, "rpn.post_nms_top_n_train": 50}
BN_SHAPE = (4, 8, 5, 6)  # x of the SyncBN check, split 2 + 2 over the ranks
WORKER_TIMEOUT = 240
# bounds on max |got - want| / max |want|, about twice the gaps measured
# (test_two_process_gloo_matches_one_process_and_jax_mesh), one ulp where 0
BN_BOUNDS = {"out": 2e-7, "dx": 2e-7, "dgamma_mean": 2e-7, "dbeta_mean": 2e-7,
             "ra_mean": 1.2e-7, "ra_var": 1.2e-7, "local_out": 1.2e-7}
STEP_BOUNDS = {"losses": 1.2e-3, "grad_norm": 7e-4, "stats": 8e-4, "param_norm": 2e-10}


def bn_state(rng):
    return {"gamma": rng.uniform(0.5, 1.5, BN_SHAPE[1]).astype(np.float32),
            "beta": rng.randn(BN_SHAPE[1]).astype(np.float32),
            "mean": rng.randn(BN_SHAPE[1]).astype(np.float32) * 0.1,
            "var": rng.uniform(0.5, 1.5, BN_SHAPE[1]).astype(np.float32)}


def run_bn(bn: SyncBatchNorm, x: np.ndarray, g: np.ndarray) -> dict:
    """Train-mode ``bn`` on x with L = sum(out * g): out, dx, dgamma, dbeta."""
    xt = torch.from_numpy(x).requires_grad_()
    out = bn(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return {"out": out.detach().numpy(), "dx": xt.grad.numpy(),
            "dgamma": bn.gamma.grad.numpy(), "dbeta": bn.beta.grad.numpy()}


def make_bn(state: dict, kind: str = "sync_bn") -> SyncBatchNorm:
    bn = make_norm(kind)(BN_SHAPE[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return bn


# ---------------------------------------------------------------- the worker


def worker(inputs: str, rank: int, port: int, out: str) -> None:
    """One rank of the 2-process group: every check's local half."""
    torch.set_num_threads(1)  # the suite's other workers share these cores
    mesh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
    d = np.load(inputs)
    res = {}

    bn = make_bn({k: d[f"bn_{k}"] for k in ("gamma", "beta", "mean", "var")})
    half = slice(2 * rank, 2 * rank + 2)
    got = run_bn(bn, d["bn_x"][half], d["bn_g"][half])
    dgb = torch.from_numpy(np.concatenate([got["dgamma"], got["dbeta"]]))
    torch.distributed.all_reduce(dgb)
    res.update({f"bn_{k}": got[k] for k in ("out", "dx")},
               bn_dgamma_mean=(dgb[:BN_SHAPE[1]] / 2).numpy(),
               bn_dbeta_mean=(dgb[BN_SHAPE[1]:] / 2).numpy(),
               bn_ra_mean=bn.mean.numpy(), bn_ra_var=bn.var.numpy())

    local = make_bn({k: d[f"bn_{k}"] for k in ("gamma", "beta", "mean", "var")}, kind="bn")
    res["bn_local_out"] = run_bn(local, d["bn_x"][half], d["bn_g"][half])["out"]

    gathered = all_gather_objects({"rank": rank, "rows": list(range(rank + 1))})
    assert gathered == [{"rank": r, "rows": list(range(r + 1))} for r in range(2)], gathered

    cfg = load_config(SYNC, DP_OVERRIDES)
    model = build_detector(cfg, device="cpu", train=True)
    prefix = "sd/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(d[k]) for k in d.files
                           if k.startswith(prefix)}, strict=True)
    trainer = Trainer(cfg, model, steps_per_epoch=100, device="cpu")
    batch = {k[len("batch/"):]: d[k][rank:rank + 1] for k in d.files if k.startswith("batch/")}

    def draws(name, shape):
        u = torch.from_numpy(d[f"draw/{name}"])
        assert tuple(u.shape) == shape, (name, tuple(u.shape), shape)
        return u

    metrics = trainer.run_step(batch, draws=draws)
    res.update({f"metric/{k}": v.numpy() for k, v in metrics.items()})
    res.update({f"stat/{k}": v.numpy() for k, v in model.state_dict().items()
                if k.endswith((".mean", ".var"))})
    res["param_norm"] = np.float64(torch.sqrt(sum((p.double() ** 2).sum()
                                                  for p in model.parameters())))
    np.savez(out, **res)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------- the parent


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_batch(rng, n: int) -> dict:
    gt = np.zeros((n, 4, 4), np.float32)
    gt[:, 0] = [10.0, 12.0, 80.0, 70.0]
    gt[:, 1] = [40.0, 30.0, 140.0, 95.0]
    return {"raw": rng.randint(0, 256, (n, 100, 150, 3)).astype(np.uint8),
            "hw": np.asarray([[100.0, 150.0], [90.0, 140.0]][:n], np.float32),
            "flip": np.asarray([False, True][:n]), "gt_boxes": gt,
            "gt_labels": np.tile(np.asarray([[1, 3, 0, 0]], np.int32), (n, 1)),
            "gt_valid": np.tile(np.asarray([[True, True, False, False]]), (n, 1))}


def draw_shapes(cfg, batch: dict) -> dict:
    """The (2, 1, n) draw shapes of a one-image step, read off a port step
    fed random draws (``n`` depends on the canvas's anchors)."""
    shapes = {}

    def record(name, shape):
        shapes[name] = shape
        return torch.rand(shape)

    Trainer(cfg, device="cpu", seed=0).run_step({k: v[:1] for k, v in batch.items()},
                                                draws=record)
    return shapes


def test_two_process_gloo_matches_one_process_and_jax_mesh():
    """Measured gaps on the CPU, each over the largest reference value:
    SyncBN over two ranks against BN over the whole x, output 9.5e-8, dx
    7.9e-8, averaged dgamma 9.2e-8 and dbeta 2.2e-8, running statistics 0;
    kind "bn" on a rank against BN over its half, 0. The world-2 step
    against the JAX step on a 2-device mesh: the loss 1.2e-4 relative, the
    loss terms up to 6.0e-4 (``loss_rcnn_reg0``), the grad norm 3.6e-4,
    the running statistics 4.1e-4, the parameter norm after the update
    9.8e-11; the discrete metrics equal. The gaps are of the size of the
    one-process fixture's (``test_sync_bn_train_step_reproduces_jax_fixture``): batch
    statistics pass summation-order differences on from layer to layer,
    and at 128x160 stage 4 normalises 20 values a channel and replica.
    Bounds are about twice the gaps (``BN_BOUNDS``, ``STEP_BOUNDS``). Both
    ranks end with the same metrics, statistics and parameter norm."""
    import jax
    import jax.numpy as jnp
    from mxdetection_tpu.config import load_config as jax_load_config
    from mxdetection_tpu.models.registry import build_detector as jax_build_detector
    from mxdetection_tpu.parallel import make_mesh
    from mxdetection_tpu.train import Trainer as JaxTrainer
    from mxdetection_tpu_torch.utils.convert import flax_to_state_dict

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_port_train import jax_draws

    cfg = load_config(SYNC, DP_OVERRIDES)
    jcfg = jax_load_config(os.path.join(REPO, f"configs/{SYNC}.py")).override(**DP_OVERRIDES)
    bundle = jax_build_detector(jcfg)
    rng = np.random.RandomState(21)
    batch = dp_batch(rng, 2)
    tb0 = {"images": jnp.zeros((1, 128, 160, 3)), "im_info": jnp.asarray([[128.0, 160, 1.0]]),
           "gt_boxes": jnp.zeros((1, 4, 4)), "gt_labels": jnp.zeros((1, 4), jnp.int32),
           "gt_valid": jnp.zeros((1, 4), bool)}
    variables = jax.device_get(jax.jit(bundle.init)(jax.random.PRNGKey(7), tb0))
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed), 0)
    draws = {name: jax_draws(key)(name, shape).numpy()
             for name, shape in draw_shapes(cfg, batch).items()}
    bn_rng = np.random.RandomState(5)
    x = (bn_rng.randn(*BN_SHAPE) * 2 + 0.5).astype(np.float32)
    g = bn_rng.randn(*BN_SHAPE).astype(np.float32)
    state = bn_state(bn_rng)

    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, bn_x=x, bn_g=g, **{f"bn_{k}": v for k, v in state.items()},
                 **{f"sd/{k}": v.numpy() for k, v in flax_to_state_dict(variables).items()},
                 **{f"batch/{k}": v for k, v in batch.items()},
                 **{f"draw/{k}": v for k, v in draws.items()})
        port = free_port()
        env = {**os.environ, "PYTHONPATH": REPO}
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), inputs, str(r), str(port),
             os.path.join(tmp, f"out{r}.npz")], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            # the references, while the workers run
            ref_bn = run_bn(make_bn(state), x, g)
            ref_ra = make_bn(state)
            ref_ra(torch.from_numpy(x))
            mesh2 = make_mesh((-1, 1), devices=jax.devices()[:2])
            jt = JaxTrainer(jcfg, bundle.apply_train, variables, bundle.loss_fn, mesh2,
                            steps_per_epoch=100)
            ref = {k: float(v) for k, v in jt.run_step(batch).items()}
            ref_stats = flax_to_state_dict({"batch_stats": jax.device_get(
                jt.state.batch_stats)})
            ref_norm = float(np.sqrt(sum(np.sum(np.asarray(p, np.float64) ** 2)
                                         for p in jax.tree.leaves(jt.state.params))))
            logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
        outs = [dict(np.load(os.path.join(tmp, f"out{r}.npz"))) for r in range(2)]

    bn_gaps = {}
    for r, o in enumerate(outs):
        half = slice(2 * r, 2 * r + 2)
        for k, want in (("out", ref_bn["out"][half]), ("dx", ref_bn["dx"][half]),
                        ("dgamma_mean", ref_bn["dgamma"] / 2), ("dbeta_mean", ref_bn["dbeta"] / 2),
                        ("ra_mean", ref_ra.mean.numpy()), ("ra_var", ref_ra.var.numpy())):
            bn_gaps[k] = max(bn_gaps.get(k, 0.0), rel_gap(o[f"bn_{k}"], want))
        # kind "bn" normalises each rank's half by its own statistics
        local = run_bn(make_bn(state), x[half], g[half])["out"]
        bn_gaps["local_out"] = max(bn_gaps.get("local_out", 0.0),
                                   rel_gap(o["bn_local_out"], local))
        assert rel_gap(o["bn_out"], local) > 1e-2
    assert all(bn_gaps[k] <= BN_BOUNDS[k] for k in bn_gaps), bn_gaps

    got = {k[len("metric/"):]: float(v) for k, v in outs[0].items() if k.startswith("metric/")}
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    gaps = {k: abs(got[k] - r) / abs(r) for k, r in ref.items() if r}
    stats = {k[len("stat/"):]: v for k, v in outs[0].items() if k.startswith("stat/")}
    assert set(stats) == set(ref_stats)
    gaps["stats"] = max(rel_gap(v, ref_stats[k].numpy()) for k, v in stats.items())
    gaps["param_norm"] = abs(float(outs[0]["param_norm"]) - ref_norm) / ref_norm
    for k in ("num_pos_rois", "rcnn_acc0"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    bounds = {k: STEP_BOUNDS.get(k, STEP_BOUNDS["losses"]) for k in gaps}
    assert all(gaps[k] <= bounds[k] for k in gaps), (gaps, bounds)
    assert any(np.abs(v).max() > 0 for k, v in stats.items() if k.endswith(".mean"))
    for k, v in outs[1].items():  # the ranks' updates are one all-reduced gradient
        if k.startswith(("stat/", "metric/", "param_norm")):
            np.testing.assert_array_equal(v, outs[0][k], err_msg=k)


# ---------------------------------------------------------------- single process


def test_data_parallel_size_resolves_the_mesh_shape():
    assert mesh.world_size() == 1
    assert mesh.data_parallel_size((-1, 1)) == 1
    assert mesh.data_parallel_size((-1, 1), n_replicas=16) == 16
    assert mesh.data_parallel_size((4, 1), n_replicas=4) == 4
    assert mesh.data_parallel_size(load_config(SYNC).train.mesh_shape, n_replicas=2) == 2
    with pytest.raises(NotImplementedError, match="model axis"):
        mesh.data_parallel_size((-1, 2), n_replicas=4)
    with pytest.raises(ValueError, match="replicas"):
        mesh.data_parallel_size((4, 1), n_replicas=2)


def test_single_process_needs_no_group():
    """Single-process: no group is started, ``all_gather_objects`` returns
    ``[obj]`` without collectives, SyncBN is plain train-mode BN."""
    mesh.initialize_multihost()
    mesh.initialize_multihost(num_processes=1)
    assert not torch.distributed.is_initialized()
    obj = {"dets": [1, 2]}
    assert all_gather_objects(obj) == [obj]
    with pytest.raises(ValueError, match="coordinator"):
        mesh.initialize_multihost(num_processes=2)


def test_entry_points_default_to_the_card_with_sync_bn():
    """``build_detector`` and ``Trainer`` of the SyncBN config raise without
    a card unless asked for the CPU, as the other configs'."""
    assert not torch.cuda.is_available()
    cfg = load_config(SYNC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    model = build_detector(cfg.override(**{"backbone.dtype": "float32"}), device="cpu")
    assert isinstance(model.backbone.stem_bn, SyncBatchNorm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, model)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
