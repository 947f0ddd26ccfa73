"""Device time of the exact engine's fold per request: the kernels,
copies and memsets launched inside the program's ``vt.exact`` span
(``harness.spans``), summed over a request, median over the window's
requests."""

from harness import spans

spans.attach()


def read(run):
    return spans.median_ms(run, "vt.exact", "device_s")
