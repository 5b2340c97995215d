"""The scan_roofline_pct metric (%).

read(ctx) returns its value from what a run gathered, or None where it finds
nothing to read."""

import re
import sys

from portbench import harness, peaks


def read(ctx):
    """The least time of the traced scan launches over their device time,
    in %. Set-up records a request's scan calls in order; every traced
    request makes the same calls, so the j-th traced launch of a combine
    and dtype (by start time, the kernel's name giving both) is call j of
    its request and carries that call's least time (bytes and operations,
    ``peaks.scan_work``). Where the trace holds another number of launches
    of a combine and dtype than the traced requests made, or the port's
    launch counters over those requests count another number than set-up
    recorded, launches and calls cannot be paired: None."""
    tr = ctx["trace"]
    if not tr:
        return None
    n = tr["requests"]
    calls, per_op = {}, {}
    for item in ctx["work"]:
        if item[0] == "scan":
            _, op, shape, dt = item
            calls.setdefault((op, dt), []).append(peaks.bound_s(*peaks.scan_work(op, shape, dt), dt))
            per_op[op] = per_op.get(op, 0) + 1
    counters = ctx.get("launches") or {}
    counted = {op: counters.get(f"scan_block/{op}", 0) + counters.get(f"scan_tiled/{op}", 0) for op in per_op}
    patterns = harness.kernel_patterns(ctx["metric_dir"])
    launches = {}
    for name, s, e, _ in sorted(tr["events"], key=lambda ev: ev[1]):
        if not harness.is_copy(name) and harness.matches(name, patterns):
            launches.setdefault(combine_of(name), []).append((e - s) / 1e9)
    traced = {key: len(t) for key, t in launches.items()}
    made = {key: n * len(c) for key, c in calls.items()}
    if not calls or traced != made or counted != {op: n * c for op, c in per_op.items()}:
        print(f"scan_roofline_pct: not read: launches traced {traced}, made by {n} requests {made}, "
              f"counted {counted}", file=sys.stderr)
        return None
    bound = sum(calls[key][j % len(calls[key])] for key, times in launches.items() for j in range(len(times)))
    busy = sum(sum(times) for times in launches.values())
    return 100.0 * bound / busy


def combine_of(name: str):
    """(combine, dtype) from a scan kernel's name, demangled or not."""
    m = re.search(r"(QuatChain|Filter|RtsSuffix|Mobius|Affine3|Add2|Max3|Min3)(?:<|I)(float|double|f|d)\b", name)
    if m is None:
        return None
    return peaks.COMBINE_OF_TYPE[m.group(1)], "float64" if m.group(2) in ("double", "d") else "float32"
