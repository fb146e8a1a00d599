"""K1 (RoIAlign forward): least seconds over device seconds under mxdet::roi_align, %."""
from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "infer", "roi_align_fwd", ops=("mxdet::roi_align",),
                    kernels=("roi_align_fwd_kernel",))
