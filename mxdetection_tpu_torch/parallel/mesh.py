"""Process-group bring-up and the data-parallel size — port of
``mxdetection_tpu.parallel.mesh``.

The JAX package builds a ("data", "model") mesh over every device and
lowers the gradient and SyncBN reductions to collectives inside its jitted
step. The port runs one process per card in a ``torch.distributed`` process
group (NCCL on the card, gloo on the CPU) and reduces explicitly: SyncBN
averages its statistics (``models/layers.py``) and the ``Trainer`` its
gradients. The model axis is 1 in every config (the JAX step replicates
over it), so only the data axis is ported.

Where the JAX tools find their processes through the TPU runtime, the
port's tools read torch's launcher variables (``initialize_from_env``):
``python -m torch.distributed.run --nproc_per_node N -m
mxdetection_tpu_torch.tools.train ...`` starts N ranks, one a card.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, device="cuda",
                         backend: str | None = None) -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, meeting at ``coordinator`` (``host:port``, a TCP
    rendezvous that rank 0 serves). NCCL when ``device`` is a CUDA device,
    gloo on the CPU, unless ``backend`` names another. No-op when
    single-process without a coordinator, as the JAX function; a failed
    bring-up raises."""
    if not (coordinator is not None or (num_processes or 1) > 1):
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number of processes "
                         "and this process's id")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def initialize_from_env(device="cuda") -> bool:
    """Join the process group that torch's launcher describes in
    ``LAUNCHER_VARS`` (``torch.distributed.run`` sets them all), with
    ``device``'s backend (``initialize_multihost``) and, for a card, this
    rank's card (``local_device``) as the current one.
    Returns whether it joined one: nothing happens without ``WORLD_SIZE``,
    at ``WORLD_SIZE=1`` or when this process is already in a group (a
    caller that started one itself). A partial environment raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or (dist.is_available() and dist.is_initialized()):
        return False
    missing = [k for k in LAUNCHER_VARS if k not in os.environ]
    if missing:
        raise ValueError(f"WORLD_SIZE={world} without {', '.join(missing)}: a launcher "
                         f"sets all of {', '.join(LAUNCHER_VARS)}")
    dev = local_device(device, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_multihost(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
                         int(os.environ["RANK"]), device=dev)
    return True


def local_device(device, world: int) -> torch.device:
    """``device`` for this rank of ``world`` (the process group's size):
    with more than one rank and ``LOCAL_RANK`` set, ``cuda`` without an
    index is ``cuda:LOCAL_RANK`` (one card a process); an explicit index or
    another device is kept. A ``LOCAL_RANK`` past the cards this host has
    raises: there is no fallback."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or world == 1 or "LOCAL_RANK" not in os.environ:
        return dev
    local = int(os.environ["LOCAL_RANK"])
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local} but this host has "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", local)


def world_size() -> int:
    """The number of data-parallel replicas: the process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the process group, 0 without one."""
    return dist.get_rank() if world_size() > 1 else 0


def data_parallel_size(mesh_shape=(-1, 1), n_replicas: int | None = None) -> int:
    """Resolve ``mesh_shape`` (data, model) against the replicas (the
    process group's size by default): -1 fills with what is left, as
    ``make_mesh`` does. A model axis above 1 raises: no config uses one."""
    n = world_size() if n_replicas is None else n_replicas
    shape = list(mesh_shape)
    if len(shape) != 2:
        raise ValueError(f"mesh shape {tuple(mesh_shape)} is not (data, model)")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = n // known
    if shape[1] != 1:
        raise NotImplementedError(f"mesh shape {tuple(mesh_shape)}: a model axis above 1 "
                                  "is not ported (no config uses one)")
    if shape[0] != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} replicas")
    return shape[0]
