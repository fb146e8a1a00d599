"""Mean device-timeline ms a batch of the backbone span (CUDA events at module boundaries)."""
from benchmark.readers import stage_ms


def read(rec):
    return stage_ms(rec, "infer", "backbone")
