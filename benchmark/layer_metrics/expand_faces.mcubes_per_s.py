"""The face expansion's work rate: the active cubes kernel B emitted per
request (the program's ``marching_cubes_fused.cubes`` over the traced
window) over the mean host seconds of the program's ``vt.expand_faces``
span per request, in millions of cubes a second."""

import statistics

from harness import spans

spans.attach()


def read(run):
    if run.trace is None:
        return None
    cubes = getattr(run.trace, "counters", {}).get("mc_active_cubes")
    seconds = spans.per_request(run.trace, "vt.expand_faces", "host_s")
    meshed = sum(1 for r in run.requests if r.mesh_size)
    if not cubes or not seconds or not meshed:
        return None
    return cubes / meshed / statistics.mean(seconds) / 1e6
