"""Mean device-timeline ms a batch of the roi_heads span (CUDA events at module boundaries)."""
from benchmark.readers import stage_ms


def read(rec):
    return stage_ms(rec, "infer", "roi_heads")
