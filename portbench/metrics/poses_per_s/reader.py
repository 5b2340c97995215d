"""The poses_per_s metric (poses/s).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""


def read(ctx):
    """Real poses of the requests completed in the window over the time
    from the window's start to the last completion in it."""
    if not ctx["poses_completed"] or ctx["window_to_last_s"] <= 0:
        return None
    return ctx["poses_completed"] / ctx["window_to_last_s"]
