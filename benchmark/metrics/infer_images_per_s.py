"""Images whose detections reached the host in the window, a second."""
from benchmark.readers import images_per_s


def read(rec):
    return images_per_s(rec, "infer")
