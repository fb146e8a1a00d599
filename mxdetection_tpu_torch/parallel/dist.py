"""Cross-process host-data exchange — port of ``mxdetection_tpu.parallel.dist``.

The JAX function pickles the object and gathers padded uint8 rows in two
collectives; ``torch.distributed.all_gather_object`` does the same over the
process group.
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
