"""The device_idle_pct metric (%).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

from portbench import harness


def read(ctx):
    """1 − (the union of the cards' kernel and copy intervals) / the traced
    wall, averaged over the cards, in %."""
    tr = ctx["trace"]
    if not tr or not tr["events"]:
        return None
    wall = tr["t1_ns"] - tr["t0_ns"]
    devices = sorted({d for _, _, _, d in tr["events"]})
    busy = sum(harness.busy_ns(tr["events"], d) for d in devices) / ctx["chips"]
    return 100.0 * (1.0 - busy / wall)
