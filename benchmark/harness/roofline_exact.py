"""The least time the card could take for the exact engine's fold,
counted from shapes alone, whatever implements the fold: plain torch
today, a fused kernel later."""

from .roofline import bound_s

# float32 operations per voxel and view of the per-voxel Carve
# (voxel_carver.cc:453-491), a comparison or a select counting one:
# the world-to-camera transform, three rows of three products and three
# sums (18); the projection, per image axis a division, a product and a
# sum (6); the skips, z < 0, two finiteness tests and four bounds (7);
# the bilinear taps, per axis a floor, the +1, its clamp and the
# fraction (8), the four flat indices, a product and a sum each (8),
# 1 - a and 1 - b (2), the four weights (4), four products and three
# sums (7); the update, the cap, first touch, d > sdf, their union, the
# select of sdf and the count (6)
EXACT_OPS_PER_FUSION = 18 + 6 + 7 + 8 + 8 + 2 + 4 + 7 + 6


def exact_bound_s(nz, ny, nx, views, h, w):
    """(seconds, "bytes" or "operations") of folding ``views`` images of
    ``h x w`` float32 into a state of ``nz x ny x nx`` voxels: the state
    (float32 sdf and int32 count) read and written once, the images read
    once, ``EXACT_OPS_PER_FUSION`` operations per voxel and view."""
    voxels = nz * ny * nx
    return bound_s(2 * 8 * voxels + 4 * views * h * w,
                   voxels * views * EXACT_OPS_PER_FUSION)
