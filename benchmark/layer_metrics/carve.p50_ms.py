"""Median of the benchmark's span around ``carve_batch`` (the 2D SDF, the
warp dispatch, kernel A and the SDF-image return), ending in a device
synchronize."""


def read(run):
    return run.p50_ms("carve_batch")
