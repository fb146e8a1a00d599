"""K6, K6b, K7, K7b (deformable conv backward): least seconds over their kernels' device seconds, %."""
from benchmark.readers import roofline


def read(rec):
    return roofline(rec, "train", "dcn_bwd",
                    kernels=("wgrad_kernel", "g_tiles_kernel", "wgrad_finish_kernel",
                             "wgrad_f32_kernel", "deform_col2im_kernel"))
