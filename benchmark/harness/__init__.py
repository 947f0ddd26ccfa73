"""The benchmark's harness: cells as data, the scene generator, the
timed loop, the reading of the trace, the roofline arithmetic and the
comparison that decides ``correct``."""
