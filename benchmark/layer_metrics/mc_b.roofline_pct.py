"""Kernel B's share of its roofline: the byte bound of each request's
extraction (``harness.roofline.mc_b_bound_s``, from its mesh) summed over
the window, over the device time of B's count, scan and emit kernels in
the trace."""

from harness import roofline

B_KERNELS = ("mc_count_kernel", "mc_scan_", "mc_plane_counts_kernel",
             "mc_emit_kernel")


def read(run):
    meshed = [r.mesh_size for r in run.requests if r.mesh_size]
    if run.trace is None or not meshed:
        return None
    seconds, launches = run.trace.kernel_time(*B_KERNELS)
    if seconds <= 0 or launches == 0:
        return None
    s = run.shape
    bound = sum(roofline.mc_b_bound_s(s["nz"], s["ny"], s["nx"], v, f)[0]
                for v, f in meshed)
    return 100.0 * bound / seconds
