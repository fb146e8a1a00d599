"""The CUDA kernels' wrappers, and their launch counts taken together.

Each wrapper module counts its kernels' launches (``build.LaunchCount``);
``reset_launches`` and ``read_launches`` read all of them at once, for a
tool or a check that shows which kernels a run launched.
"""

from __future__ import annotations


def launch_counters() -> list:
    """Every kernel wrapper's launch count, K1 to K7b and the FrozenBN
    epilogue's two."""
    from . import deform_conv, iou, nms, norm_act, roi_align

    return [roi_align.launch_count, nms.launch_count, roi_align.bwd_launch_count,
            roi_align.bwd_bf16_launch_count, iou.launch_count, iou.pass_a_count,
            iou.pass_b_count, deform_conv.launch_count, deform_conv.s2_launch_count,
            deform_conv.wgrad_launch_count, deform_conv.wgrad_s2_launch_count,
            deform_conv.col2im_launch_count, deform_conv.col2im_s2_launch_count,
            norm_act.launch_count, norm_act.bwd_launch_count]


def reset_launches() -> None:
    for c in launch_counters():
        c.reset()


def read_launches() -> dict:
    """{kernel: launches} of the kernels launched since ``reset_launches``."""
    return {c.name: c.n for c in launch_counters() if c.n}
