"""Mean host ms a batch or step inside the entry call."""
from benchmark.readers import host_ms


def read(rec):
    return host_ms(rec, "train")
