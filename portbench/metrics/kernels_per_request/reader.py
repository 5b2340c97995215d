"""The kernels_per_request metric (kernels).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

from portbench import harness


def read(ctx):
    """Device kernels in the trace over the traced requests."""
    tr = ctx["trace"]
    if not tr or not tr["events"]:
        return None
    return sum(1 for name, *_ in tr["events"] if not harness.is_copy(name)) / tr["requests"]
