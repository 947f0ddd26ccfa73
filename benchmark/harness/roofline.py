"""Published peaks of one NVIDIA H100 and the least time the card could
take for the work of kernels A and B, counted from shapes alone.

Peaks (NVIDIA's H100 SXM data sheet, at the full 700 W): 3.35 TB/s of
device memory, 67 TFLOP/s of float32 outside the tensor cores, counting
a multiply-add as two operations.
"""

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# float32 operations of the fused warp kernel (A), counted from its
# formulation: per voxel and view (pass 2: three 4-operation sums, two
# divisions, four multiply-adds, the clip, the blend, the masks and the
# update), and per (z-plane, image row, x) and view (pass 1: u_eq and the
# blend)
WARP_OPS_PER_FUSION = 48
WARP_OPS_PER_PASS1 = 30


def bound_s(n_bytes, n_ops):
    """(seconds, "bytes" or "operations"): the larger of moving
    ``n_bytes`` and doing ``n_ops`` float32 operations at the peaks."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = n_ops / PEAK_F32_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_a_bound_s(nz, ny, nx, views, h, w, linear=True):
    """Kernel A folding ``views`` images of ``h x w`` float32 into a state
    of ``nz x ny x nx`` voxels (float32 sdf and int32 count, read and
    written once, the images read once). Pass 1 is counted only over the
    rows a (z, x) column of voxels can tap: two per voxel (bilinear) or
    one, so at most ``min(h, 2 ny)``."""
    voxels = nz * ny * nx
    rows = min(h, (2 if linear else 1) * ny)
    return bound_s(2 * 8 * voxels + 4 * views * h * w,
                   views * (voxels * WARP_OPS_PER_FUSION
                            + nz * rows * nx * WARP_OPS_PER_PASS1))


def mc_b_bound_s(nz, ny, nx, vertices, faces):
    """Kernel B (count, scan and emit) over a state of ``nz x ny x nx``
    voxels, by bytes: the sdf and count read once; each vertex's stream
    entry (its coordinate and owner id, 8 bytes) and each active cube's
    (its id and case, 8 bytes) written once. A cube gives at most five
    faces, so a mesh of ``faces`` faces had at least ``faces / 5`` active
    cubes: the count is never above what the kernel must write."""
    cubes = -(-faces // 5)
    return bound_s(8 * nz * ny * nx + 8 * vertices + 8 * cubes, 0)
