"""Idle device time inside the program's ``vt.image_return`` span
(``carver._host_array``) per request, median over the window's requests:
the host's write of the SDF images while nothing runs on the card, not
the wait on kernel A, which keeps the card busy."""

from harness import spans

spans.attach()


def read(run):
    return spans.median_ms(run, "vt.image_return", "idle_s")
