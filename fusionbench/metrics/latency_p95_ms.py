"""Open loop: the 95th percentile, over every frame due in the window,
of the time from the frame's due (capture) time to its pose on the
host; a frame whose pose never came reads as infinitely late."""

import statistics


def read(run):
    if not run.latencies:
        return None
    lat = sorted(run.latencies) + [float("inf")] * run.failed
    if len(lat) < 20:
        return None
    p95 = statistics.quantiles(lat, n=20, method="inclusive")[-1]
    return p95 * 1000.0 if p95 != float("inf") else None
