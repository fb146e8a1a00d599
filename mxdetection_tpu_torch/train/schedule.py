"""LR schedule: linear warmup + multi-step decay — port of
``mxdetection_tpu.train.schedule``.

A plain function of the step. It is evaluated in float32 with the JAX
function's order of operations, so both packages give the same rate.
"""

from __future__ import annotations

import numpy as np


def warmup_multistep(base_lr: float, *, warmup_steps: int, warmup_ratio: float,
                     decay_steps: tuple, decay_factor: float):
    """Returns f(step) -> lr (a Python float holding a float32 value):
    from ``base_lr * warmup_ratio`` linearly up to ``base_lr`` over
    ``warmup_steps``, then times ``decay_factor`` at each of ``decay_steps``."""
    f32 = np.float32
    decay_steps = tuple(int(s) for s in decay_steps)

    def schedule(step) -> float:
        step = f32(step)
        warm_frac = np.clip(step / f32(max(warmup_steps, 1)), f32(0.0), f32(1.0))
        warm_lr = f32(base_lr) * (f32(warmup_ratio) + f32(1.0 - warmup_ratio) * warm_frac)
        num_decays = f32(sum(step >= s for s in decay_steps))
        return float(warm_lr * f32(decay_factor) ** num_decays)

    return schedule
