"""The peak_mem_gib metric (GiB).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""


def read(ctx):
    """The largest peak of allocated device memory over the cell's cards
    in the window (the peaks reset after set-up)."""
    return ctx["peak_bytes"] / 2**30
