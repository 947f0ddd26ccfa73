"""The exact engine's share of its roofline: the least time its fold
could take (``harness.roofline_exact.exact_bound_s``), at the views per
request that the program's counter gives over the window
(``harness.exact_views``), over the median device time of the fold per
request (``exact.device_ms``)."""

from harness import exact_views, roofline_exact, spans

exact_views.attach()


def read(run):
    device_ms = spans.median_ms(run, "vt.exact", "device_s")
    folded = (getattr(run.trace, "counters", {}).get(exact_views.KEY)
              if device_ms else None)
    if not folded or not run.requests:
        return None
    s = run.shape
    bound, _ = roofline_exact.exact_bound_s(
        s["nz"], s["ny"], s["nx"], folded / len(run.requests),
        s["height"], s["width"])
    return 100.0 * bound / (device_ms * 1e-3)
