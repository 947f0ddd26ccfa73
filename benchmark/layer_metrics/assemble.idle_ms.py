"""Idle device time inside the program's ``vt.assemble`` span (the host
assembly of the marching-cubes streams) and outside the face expansion
nested in it (``vt.expand_faces``), per request, median over the
window's requests."""

from harness import spans

spans.attach()


def read(run):
    return spans.median_ms(run, "vt.assemble", "idle_s")
