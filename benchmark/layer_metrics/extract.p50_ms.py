"""Median of the benchmark's span around ``extract_iso_surface`` (kernel
B, the stream copies and the host assembly), ending in a device
synchronize."""


def read(run):
    return run.p50_ms("extract_iso_surface")
