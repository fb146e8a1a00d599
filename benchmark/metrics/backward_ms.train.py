"""Mean device-timeline ms a step of the backward span (CUDA events at the step's boundaries)."""
from benchmark.readers import stage_ms


def read(rec):
    return stage_ms(rec, "train", "backward")
