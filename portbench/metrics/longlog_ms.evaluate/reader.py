"""The longlog_ms.evaluate metric (ms).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

import numpy as np


def read(ctx):
    """The median, over a traced run's requests outside the trace, of the host
    span ``evaluate`` around ``parallel.mesh.evaluate_batch`` on the staged batch and the fusion's outputs, the devices synchronised at both ends."""
    ms = ctx["spans"].get("evaluate")
    return float(np.median(ms)) if ms else None
