"""The pad_waste_pct metric (%).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""


def read(ctx):
    """(padded − real) / real poses of a request's staged buckets, in %."""
    pad = ctx["pad"]
    if not pad:
        return None
    return 100.0 * (pad["padded"] - pad["real"]) / pad["real"]
