"""K3 (RoIAlign backward, with its bf16 epilogue K3b): least seconds over its kernels' device seconds, %."""
from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "train", "roi_align_bwd",
                    kernels=("roi_tables_kernel", "roi_align_bwd_kernel"))
