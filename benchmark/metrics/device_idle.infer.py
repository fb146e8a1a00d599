"""The traced slice's share (%) of time in which no kernel ran on the card."""
from benchmark.readers import device_idle


def read(rec):
    return device_idle(rec, "infer")
