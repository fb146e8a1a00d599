"""Cross-process host-data exchange — port of ``mxdetection_tpu.parallel.dist``.

The JAX function pickles the object and gathers padded uint8 rows in two
collectives; ``torch.distributed.all_gather_object`` does the same over the
process group. ``on_rank0`` runs host work that must happen once (writing
a dataset) on rank 0 and hands its result to every rank.
"""

from __future__ import annotations

import torch.distributed as dist

from .mesh import world_size


def all_gather_objects(obj) -> list:
    """Gather one picklable object per process; returns [obj_p0, obj_p1, ...].

    Single-process: returns [obj] without touching collectives, so the same
    call sites work in tests and on a cluster.
    """
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def on_rank0(fn):
    """``fn()`` on rank 0 alone; every rank returns its (picklable) result
    once rank 0 is done. Should ``fn`` raise on rank 0, the other ranks
    raise too instead of waiting. Single-process: ``fn()``."""
    if world_size() == 1:
        return fn()
    err = None
    out = [None]
    if dist.get_rank() == 0:
        try:
            out = [(True, fn())]
        except Exception as e:  # handed to the other ranks, then raised here
            err, out = e, [(False, repr(e))]
    dist.broadcast_object_list(out, src=0)
    if err is not None:
        raise err
    ok, value = out[0]
    if not ok:
        raise RuntimeError(f"rank 0 failed: {value}")
    return value
