"""The graph_replay_pct metric (%).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""


def read(ctx):
    """Replays of captured programs over all program calls in the window
    (``utils.graphs.stats``: first calls, captures, replays), in %."""
    g = ctx["graphs"]
    calls = g["first_calls"] + g["captures"] + g["replays"]
    return 100.0 * g["replays"] / calls if calls else None
