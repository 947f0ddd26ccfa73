"""Device time of the 2D SDF per request: the kernels, copies and memsets
launched inside the program's ``vt.sdf2d`` span (``harness.spans``),
summed over a request, median over the window's requests."""

from harness import spans

spans.attach()


def read(run):
    return spans.median_ms(run, "vt.sdf2d", "device_s")
