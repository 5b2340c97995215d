"""The longlog_ms.fetch metric (ms).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

import numpy as np


def read(ctx):
    """The median, over a traced run's requests outside the trace, of the host
    span ``fetch`` around ``utils.streaming.fetch`` of the fused trajectories and the error report, the devices synchronised at both ends."""
    ms = ctx["spans"].get("fetch")
    return float(np.median(ms)) if ms else None
