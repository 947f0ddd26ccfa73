"""Kernel A's share of its roofline: its bound from the shapes of a
launch (``harness.roofline.warp_a_bound_s``) times its launches in the
window, over its device time in the trace."""

from harness import roofline


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_time("warp_fused_kernel")
    if seconds <= 0 or launches == 0:
        return None
    s = run.shape
    bound, _ = roofline.warp_a_bound_s(s["nz"], s["ny"], s["nx"],
                                       s["views"], s["height"], s["width"])
    return 100.0 * bound * launches / seconds
