"""Port parity, multi-process data parallelism through the command-line
tools — the port's counterpart of ``tests/test_multiprocess.py``.

The parent (pytest) starts real processes with torch's launcher variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
on the SyncBN config cut as ``DP_OVERRIDES`` of ``test_torch_port_dp.py``,
on the CPU over gloo, one torch thread each:

- two ranks of ``python -m mxdetection_tpu_torch.tools.train --synthetic 8
  --epochs 1`` and, beside them, two ranks of this file run as a script,
  which step a ``Trainer`` of the same seed by hand over
  ``DetectionLoader(num_shards=2, shard_index=rank)``'s batches, the
  loader's epoch 0 twice straight through (they import no jax and load no
  ``conftest.py``);
- then two ranks of ``python -m mxdetection_tpu_torch.tools.eval
  --checkpoint`` and one process without a group and, beside them, two
  ranks of ``tools.train --resume --epochs 1`` in a copy of the first run's
  directory: as the JAX tool, ``--epochs`` counts the epochs run after the
  restore, from the loader's epoch 0.

It holds: both ranks log the same losses at every step; rank 0 alone
writes the log file, ``metrics.jsonl`` and the one checkpoint; the images
the ranks step on are disjoint and together are the one-shard loader's
global batches, in order; the CLI's checkpoint is bit-identical to the
hand-stepped ``Trainer``'s after its first pass (whose ranks end with the
same parameters); every rank of the resumed run restores that checkpoint,
logs the losses of the hand-stepped second pass and ends on its
parameters, momentum traces and step bit for bit; the two-rank evaluation gives both ranks the same table, equal to the
one-process table. The step-level parity with the JAX 2-device mesh is
``test_torch_port_dp.py``'s. The unit cases below hold the launcher
environment's join (``parallel.mesh.initialize_from_env``).
"""

import glob
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile

if __name__ == "__main__":  # a worker: the port alone, as on the card's machine
    for blocked in ("jax", "flax", "optax", "mxdetection_tpu"):
        sys.modules[blocked] = None

import pytest
import torch
import torch.distributed as dist

from mxdetection_tpu_torch.config import load_config
from mxdetection_tpu_torch.data.coco import CocoDataset
from mxdetection_tpu_torch.parallel import mesh
from mxdetection_tpu_torch.tools.common import load_dataset, parse_overrides, process_group
from mxdetection_tpu_torch.tools.train import make_loader
from mxdetection_tpu_torch.train.trainer import Trainer

if __name__ != "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_port_dp import DP_OVERRIDES
    from test_torch_port_train import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC = "multihost_dp_faster_rcnn_v5p16"
N_IMAGES = 8
TIMEOUT = 240
# the tools' test-time cut: few proposals, every score kept
EVAL_OVERRIDES = ["rpn.pre_nms_top_n_test=100", "rpn.post_nms_top_n_test=50",
                  "test.pre_nms_per_class=100", "test.score_thr=0.0"]
STEP_LINE = re.compile(r"INFO step (\d+) ep \d+ loss (\S+)")


def model_overrides() -> list:
    """``DP_OVERRIDES`` and one class, so that the random net's detections
    score some AP, as ``--override`` arguments."""
    return [f"{k}={v!r}" for k, v in DP_OVERRIDES.items()] + ["bbox_head.num_classes=1"]


def overrides(root: str) -> list:
    """The training run's ``--override`` list: ``model_overrides``, one
    image a rank, a log line a step, the checkpoint only at the end, under
    ``root``."""
    return (model_overrides()
            + ["data.batch_size_per_device=1", "data.num_workers=1", "train.log_every=1",
               "train.checkpoint_every_steps=1000", f"train.checkpoint_dir={root!r}"])


# ---------------------------------------------------------------- the worker


def hand_worker(root: str, out: str, overrides: list) -> None:
    """One rank of the hand-stepped reference: the CLI's config (the same
    ``overrides``), dataset, loader and ``Trainer`` of the same seed, the
    steps run here over the loader's epoch 0 twice without a checkpoint
    between (the CLI's run, then its resumed run); after each pass the
    parameters, traces, step, image ids and metrics, as a list to ``out``."""
    torch.set_num_threads(1)  # the suite's other workers share these cores
    cfg = load_config(SYNC, parse_overrides(overrides))
    with process_group("cpu"):
        rank = dist.get_rank()
        ds = load_dataset(cfg, cfg.data.train_split, N_IMAGES, os.path.join(root, "synthetic"))
        loader = make_loader(cfg, ds, num_shards=2, shard_index=rank)
        trainer = Trainer(cfg, device="cpu", seed=cfg.train.seed,
                          steps_per_epoch=loader.steps_per_epoch())
        passes = []
        for _ in range(2):
            ids, history = [], []
            for batch in loader.epoch(0):
                ids.append(batch["image_ids"].tolist())
                history.append({k: float(v) for k, v in trainer.run_step(batch).items()})
            passes.append({"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
                           "trace": [m.clone() for m in trainer.optimizer.trace],
                           "step": trainer.optimizer.count, "ids": ids, "history": history})
        torch.save(passes, out)


# ---------------------------------------------------------------- the parent


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def launch(cmd: list, rank: int | None, port: int | None) -> subprocess.Popen:
    """``cmd`` as rank ``rank`` of 2 under the launcher's variables, or
    alone (``rank`` None), on one torch thread."""
    env = {k: v for k, v in os.environ.items() if k not in mesh.LAUNCHER_VARS}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return subprocess.Popen([sys.executable, *cmd], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(procs: list) -> list:
    """(stdout, stderr) of each process, which must exit 0."""
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def tool(name: str, *args) -> list:
    return ["-m", f"mxdetection_tpu_torch.tools.{name}", "--config", SYNC, "--device", "cpu",
            *args]


def results_line(err: str) -> dict:
    lines = [x for x in err.splitlines() if " results {" in x]
    assert len(lines) == 1, err[-3000:]
    return json.loads(lines[0].split(" results ", 1)[1])


def test_two_rank_cli_train_and_eval_match_hand_steps_and_one_process():
    with tempfile.TemporaryDirectory() as tmp:
        cli_root, hand_root = os.path.join(tmp, "cli"), os.path.join(tmp, "hand")
        p_train, p_hand, p_eval, p_resume = free_ports(4)
        train = tool("train", "--synthetic", str(N_IMAGES), "--epochs", "1", "--batch-size", "1",
                     "--override", *overrides(cli_root))
        procs = [launch(train, r, p_train) for r in range(2)]
        procs += [launch([os.path.abspath(__file__), hand_root, os.path.join(tmp, f"hand{r}.pt"),
                          *overrides(hand_root)], r, p_hand) for r in range(2)]
        (out0, err0), (out1, err1), _, _ = finish(procs)

        work = os.path.join(cli_root, SYNC)
        ckpt_dir = os.path.join(work, "ckpt")
        evaluate = tool("eval", "--synthetic", str(N_IMAGES), "--batch-size", "2",
                        "--checkpoint", ckpt_dir, "--override",
                        *model_overrides(), *EVAL_OVERRIDES)
        resume_root = os.path.join(tmp, "resumed")
        shutil.copytree(cli_root, resume_root)
        resume = tool("train", "--synthetic", str(N_IMAGES), "--epochs", "1", "--batch-size", "1",
                      "--resume", "--override", *overrides(resume_root))
        procs = [launch(evaluate, r, p_eval) for r in range(2)] + [launch(evaluate, None, None)]
        procs += [launch(resume, r, p_resume) for r in range(2)]
        *evals, (_, r_err0), (_, r_err1) = finish(procs)

        # the CLI's ranks: the same losses at every step, written by rank 0 alone
        steps = [STEP_LINE.findall(err) for err in (err0, err1)]
        assert steps[0] == steps[1] and len(steps[0]) >= 2, (err0[-2000:], err1[-2000:])
        logs = glob.glob(os.path.join(work, "*.log"))
        assert len(logs) == 1
        with open(logs[0]) as fh:
            text = fh.read()
        assert "rank 0 of 2, 1 images a step of 2" in text and "rank 1 of 2" not in text
        assert STEP_LINE.findall(text) == steps[0]
        assert "rank 1 of 2, 1 images a step of 2" in err1
        with open(os.path.join(work, "metrics.jsonl")) as fh:
            metrics = [json.loads(line) for line in fh]
        assert [m["step"] for m in metrics] == [int(s) for s, _ in steps[0]]
        assert [f"{m['loss']:.4f}" for m in metrics] == [loss for _, loss in steps[0]]
        assert os.listdir(ckpt_dir) == [f"step_{len(metrics)}.pt"]
        assert sorted(os.listdir(cli_root)) == [SYNC]
        assert not out0 and not out1

        # the hand-stepped ranks: disjoint shards of the one-shard loader's
        # global batches, the same parameters, and the CLI's run bit for bit
        hand, hand2 = zip(*(torch.load(os.path.join(tmp, f"hand{r}.pt"), weights_only=True)
                            for r in range(2)))
        cfg = load_config(SYNC, parse_overrides(overrides(cli_root)))
        syn = os.path.join(work, "synthetic")
        split = cfg.data.train_split
        ds = CocoDataset(os.path.join(syn, f"instances_{split}.json"),
                         os.path.join(syn, f"images_{split}"))
        one_shard = [b["image_ids"].tolist() for b in make_loader(
            cfg.override(**{"data.batch_size_per_device": 2}), ds, num_shards=1,
            shard_index=0).epoch(0)]
        assert len(one_shard) == len(metrics)
        for r in range(2):
            assert hand[r]["ids"] == [g[r::2] for g in one_shard]
        assert not set(sum(hand[0]["ids"], [])) & set(sum(hand[1]["ids"], []))
        assert hand[0]["history"] == hand[1]["history"]
        assert [{k: m[k] for k in h} for m, h in zip(metrics, hand[0]["history"],
                                                      strict=True)] == hand[0]["history"]
        ckpt = torch.load(os.path.join(ckpt_dir, f"step_{len(metrics)}.pt"), weights_only=True)
        assert ckpt["step"] == hand[0]["step"] == hand[1]["step"] == len(metrics)
        for k, v in ckpt["model"].items():
            for r in range(2):
                assert torch.equal(hand[r]["model"][k], v), (r, k)
        for a, b0, b1 in zip(ckpt["trace"], hand[0]["trace"], hand[1]["trace"], strict=True):
            assert torch.equal(a, b0) and torch.equal(a, b1)

        # the resumed run: every rank restores the checkpoint, then steps as
        # the hand-stepped second pass, and ends on its state bit for bit
        n = len(metrics)
        resumed = [STEP_LINE.findall(err) for err in (r_err0, r_err1)]
        for err in (r_err0, r_err1):
            assert f"INFO resumed from step {n}" in err, err[-2000:]
        assert resumed[0] == resumed[1] and [int(s) for s, _ in resumed[0]] == list(
            range(n + 1, 2 * n + 1)), resumed
        assert hand2[0]["history"] == hand2[1]["history"] and hand2[0]["ids"] == hand[0]["ids"]
        assert [loss for _, loss in resumed[0]] == [f"{h['loss']:.4f}"
                                                   for h in hand2[0]["history"]]
        r_ckpt_dir = os.path.join(resume_root, SYNC, "ckpt")
        assert sorted(os.listdir(r_ckpt_dir)) == [f"step_{n}.pt", f"step_{2 * n}.pt"]
        with open(os.path.join(resume_root, SYNC, "metrics.jsonl")) as fh:
            r_metrics = [json.loads(line) for line in fh]
        assert [m["step"] for m in r_metrics] == list(range(1, 2 * n + 1))
        assert [{k: m[k] for k in h} for m, h in zip(r_metrics[n:], hand2[0]["history"],
                                                      strict=True)] == hand2[0]["history"]
        ckpt2 = torch.load(os.path.join(r_ckpt_dir, f"step_{2 * n}.pt"), weights_only=True)
        assert ckpt2["step"] == hand2[0]["step"] == hand2[1]["step"] == 2 * n
        for k, v in ckpt2["model"].items():
            for r in range(2):
                assert torch.equal(hand2[r]["model"][k], v), (r, k)
        for a, b0, b1 in zip(ckpt2["trace"], hand2[0]["trace"], hand2[1]["trace"], strict=True):
            assert torch.equal(a, b0) and torch.equal(a, b1)
        assert not any(torch.equal(ckpt2["model"][k], v) for k, v in ckpt["model"].items()
                       if k.endswith("bbox_pred.weight"))

        # the evaluation: both ranks the same table, the one process's table
        (e_out0, e_err0), (e_out1, e_err1), (e_out, e_err) = evals
        two = [results_line(e_err0), results_line(e_err1)]
        one = results_line(e_err)
        table = {k: v for k, v in one.items() if k != "images_per_sec"}
        assert {k: two[0][k] for k in table} == {k: two[1][k] for k in table}
        assert two[0]["num_images"] == one["num_images"] == N_IMAGES
        for k, v in table.items():
            assert abs(two[0][k] - v) <= 1e-6, (k, two[0][k], v)
        assert table["AP50"] > 0, table
        assert "Average Precision  (AP)" in e_out0 and "weights of step" in e_out0
        assert not e_out1
        assert "Average Precision  (AP)" in e_out


# ---------------------------------------------------------------- single process


LAUNCH_ENV = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1",
              "MASTER_PORT": "1"}


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "1"}, {**LAUNCH_ENV, "WORLD_SIZE": "1"}])
def test_no_launcher_or_one_rank_joins_no_group(env, monkeypatch):
    for k in mesh.LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mesh.initialize_from_env("cpu") is False
    assert not dist.is_initialized()
    with process_group("cpu") as device:
        assert device == torch.device("cpu") and not dist.is_initialized()


@pytest.mark.parametrize("missing", mesh.LAUNCHER_VARS[:1] + mesh.LAUNCHER_VARS[2:])
def test_partial_launcher_environment_raises(missing, monkeypatch):
    for k, v in LAUNCH_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv(missing)
    with pytest.raises(ValueError, match=f"WORLD_SIZE=2 without {missing}"):
        mesh.initialize_from_env("cpu")
    assert not dist.is_initialized()


def test_local_rank_resolves_the_device(monkeypatch):
    """In a world of two, ``cuda`` is ``cuda:LOCAL_RANK``; an explicit
    index and the CPU are kept; a ``LOCAL_RANK`` past the host's cards
    raises. Alone, or without ``LOCAL_RANK``, ``cuda`` stays as it is."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.local_device("cuda", 2) == torch.device("cuda", 1)
    assert mesh.local_device("cuda:0", 2) == torch.device("cuda", 0)
    assert mesh.local_device("cpu", 2) == torch.device("cpu")
    assert mesh.local_device("cuda", 1) == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2 but this host has 2 CUDA devices"):
        mesh.local_device("cuda", 2)
    monkeypatch.delenv("LOCAL_RANK")
    assert mesh.local_device("cuda", 2) == torch.device("cuda")


def test_an_existing_group_is_kept(monkeypatch):
    """A caller that started its own group (``bench_train``'s, the card
    smoke's workers) keeps it: the launcher's variables are not read and
    ``process_group`` leaves the group as it found it."""
    port = free_ports(1)[0]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        for k, v in LAUNCH_ENV.items():
            monkeypatch.setenv(k, v)
        assert mesh.initialize_from_env("cpu") is False
        with process_group("cpu") as device:
            assert device == torch.device("cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    hand_worker(sys.argv[1], sys.argv[2], sys.argv[3:])
