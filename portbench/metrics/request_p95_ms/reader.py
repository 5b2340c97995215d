"""The request_p95_ms metric (ms).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

import numpy as np


def read(ctx):
    """The 95th percentile, over every request completed in the window, of
    the time from sending it to its results on the host."""
    lat = ctx["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
