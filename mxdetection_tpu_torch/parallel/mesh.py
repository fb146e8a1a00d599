"""Process-group bring-up and the data-parallel size — port of
``mxdetection_tpu.parallel.mesh``.

The JAX package builds a ("data", "model") mesh over every device and
lowers the gradient and SyncBN reductions to collectives inside its jitted
step. The port runs one process per card in a ``torch.distributed`` process
group (NCCL on the card, gloo on the CPU) and reduces explicitly: SyncBN
averages its statistics (``models/layers.py``) and the ``Trainer`` its
gradients. The model axis is 1 in every config (the JAX step replicates
over it), so only the data axis is ported.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, device="cuda") -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, meeting at ``coordinator`` (``host:port``, a TCP
    rendezvous that rank 0 serves). NCCL when ``device`` is a CUDA device,
    gloo on the CPU. No-op when single-process without a coordinator, as
    the JAX function; a failed bring-up raises."""
    if not (coordinator is not None or (num_processes or 1) > 1):
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number of processes "
                         "and this process's id")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def world_size() -> int:
    """The number of data-parallel replicas: the process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


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
