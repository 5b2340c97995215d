"""The nn_roofline_pct metric (%).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

import sys

from portbench import harness, peaks

# The kernels that make a call's minima: K3 and K4 themselves.
SEARCH = ("nn_kernel", "nn_grid_kernel")


def nn_bytes(query_shape, cand_shape, dtype: str) -> int:
    """The least bytes of one nearest-neighbour call, (..., N, 3) queries
    against (..., M, 3) candidates with an (..., M) mask: the queries, the
    candidates and the mask (a byte each) read once, the (..., N) minima
    written once. 716 MB for 27 rows of 465,336 float64."""
    item = peaks.ITEMSIZE[dtype]
    rows = 1
    for d in query_shape[:-2]:
        rows *= int(d)
    n, m = int(query_shape[-2]), int(cand_shape[-2])
    return rows * (n * 3 * item + m * 3 * item + m + n * item)


def read(ctx):
    """The least time of the traced requests' NN calls over the device time
    of the kernels that served them (``kernels.txt``: K3 or K4 and the keep
    lists), in %. A call's least time is its bytes (``nn_bytes``) at the
    card's memory rate: bytes alone, so that the share cannot pass 100 %
    whatever the search prunes. Set-up records a request's calls; where the
    port's launch counters (``nn_resident`` + ``nn_grid``) over the traced
    requests, or the K3 and K4 launches in the trace, differ from the calls
    × requests: None."""
    tr = ctx["trace"]
    if not tr:
        return None
    n = tr["requests"]
    calls = [item for item in ctx["work"] if item[0] == "nn"]
    counters = ctx.get("launches") or {}
    counted = counters.get("nn_resident", 0) + counters.get("nn_grid", 0)
    patterns = harness.kernel_patterns(ctx["metric_dir"])
    busy_ns, traced = 0, 0
    for name, s, e, _ in tr["events"]:
        if not harness.is_copy(name) and harness.matches(name, patterns):
            busy_ns += e - s
            traced += harness.matches(name, SEARCH)
    if not calls or counted != n * len(calls) or traced != n * len(calls) or busy_ns <= 0:
        print(f"nn_roofline_pct: not read: {len(calls)} calls a request recorded, {n} requests traced, "
              f"{counted} counted, {traced} K3/K4 launches traced", file=sys.stderr)
        return None
    bound_s = n * sum(nn_bytes(q, c, dt) for _, q, c, dt in calls) / peaks.PEAK_BYTES_PER_S
    return 100.0 * bound_s / (busy_ns / 1e9)
