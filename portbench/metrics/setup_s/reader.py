"""The setup_s metric (s).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""


def read(ctx):
    """From the harness's start to the window's start: imports, the
    kernels' build or load, the requests made from the seed, and the warm
    calls that run eagerly, capture and replay."""
    return ctx["setup_s"]
