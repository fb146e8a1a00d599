"""Model FLOPs of the window over its seconds, % of the bf16 tensor-core peak."""
from benchmark.readers import mfu


def read(rec):
    return mfu(rec, "train")
