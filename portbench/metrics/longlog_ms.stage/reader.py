"""The longlog_ms.stage metric (ms).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

import numpy as np


def read(ctx):
    """The median, over a traced run's requests outside the trace, of the host
    span ``stage`` around ``parallel.mesh.stage_batch``, the devices synchronised at both ends."""
    ms = ctx["spans"].get("stage")
    return float(np.median(ms)) if ms else None
