"""The 95th percentile of the latency of every request completed in the
window (issue to end; in a closed loop a request is issued when the last
one ended)."""

import statistics


def read(run):
    lat = [r.latency_s for r in run.requests]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
