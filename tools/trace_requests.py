"""Each request of a benchmark cell split into host and device time by
stage, from the port's tracer (``utils.profiling``), on the card.

    PYTHONPATH=. python3 tools/trace_requests.py --workload batch-kitti22 --seed 5 --seconds 30 \\
        --out build/trace_batch.json [--tracer 0] [--profiled N]

It runs the cell as ``python3 -m portbench.run`` does: the cell's flow
(``portbench/flows``), its requests from the seed, every shape warmed
(eager, captured, replayed), then a closed loop for ``--seconds`` with
Python's collector frozen and off. The tracer is enabled before the warm-up,
so that the warmed programs are the traced ones and the window holds no first
call or capture, and reset at the window's start. The window's first
``--profiled`` requests (the cell's ``traced_requests`` unless given) run
under ``torch.profiler`` (CUDA activity) with the harness's host spans
marked, the others with its spans synchronised, as in a ``--trace 1`` run;
``--profiled 0`` leaves the profiler and the harness's spans off. After the
window ``profiling.records()`` gives every span, mark and counter, and the
tool prints one JSON object (also written to ``--out``):

* ``metrics``: the per-layer numbers of ``METRICS`` and ``COUNTERS``: the
  median, over the requests after the profiled ones, of each request's
  total (the fusion's and the evaluation's stages on the device among
  them, ``fuse_device_ms.<stage>`` and ``eval_device_ms.<stage>``); a
  counter's window total a request, or the window's share (``nn_kept_pct``:
  ``nn.tiles_kept`` over ``nn.tiles_total``); None where a ring dropped a
  mark or the cell has no such record.
* ``requests``: each request's wall ms, its spans' and marks' ms by name,
  and the card's clocks after it (NVML: SM and memory MHz, performance
  state, clock event reasons).
* ``modes``: the requests split at the widest gap of their sorted walls, and
  the median of each part on either side (is a slow request slow on the
  host or on the device?).
* ``marks_vs_trace``: each mark of the profiled requests, mapped onto the
  host clock, against the start of its own mark kernel in the profiler's
  trace (median and largest gap, µs).
* ``stages``: each fusion replay's five stage spans as a share of its
  ``graphs.replay`` span; each Gauss-Newton replay's linearisation, CG, and
  the rest of the step (retract, cost, selection), ms.
* ``breakdown``: ``portbench.harness.breakdown`` of the profiled requests,
  each idle gap named by the innermost host span open at its middle, the
  program's spans beside the harness's.
* ``poses_per_s`` as ``portbench.run`` defines it, and with profiled
  requests ``kernels_per_request`` and ``device_idle_pct`` as its readers
  read them.

``--tracer 0`` keeps the tracer off and gives the walls and ``poses_per_s``:
run it beside ``--tracer 1 --profiled 0`` in one call to read what tracing
costs.
"""

from __future__ import annotations

import argparse
import bisect
import ctypes
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("alignment", "sim3_window", "ransac", "transform", "ekf_rts")
EVAL_STAGES = ("nn_slam", "nn_sim3", "nn_ekf", "ate")
# Per-layer metric -> the record whose per-request total it takes (host
# spans by name, a prefix "name" summing every "name:<program>"; device
# spans as "device:<name>").
METRICS = {
    "graph_launch_ms": "graphs.launch",
    "replay_device_ms": "device:graphs.replay",
    "sweep_host_ms.stage": "sweep.stage",
    "sweep_host_ms.rows": "sweep.drain.rows",
    **{f"fuse_device_ms.{s}": f"device:fuse.{s}" for s in STAGES},
    **{f"eval_device_ms.{s}": f"device:eval.{s}" for s in EVAL_STAGES},
    "gn_device_ms.linearise": "device:gn.linearise",
    "gn_device_ms.cg": "device:gn.cg",
}
COUNTERS = ("graph_kernels_per_request", "cg_active_pct", "nn_kept_pct")


def per_request(records: dict, windows: list) -> list:
    """For each (start_ns, end_ns) window, sorted, the ms of every host span
    and device span that starts inside it, summed by name (a device span
    as ``device:<name>``)."""
    starts = [w[0] for w in windows]
    out = [{} for _ in windows]
    for prefix, items in (("", records["spans"]), ("device:", records["marks"])):
        for name, _, a, b in items:
            k = bisect.bisect_right(starts, a) - 1
            if k >= 0 and a < windows[k][1]:
                key = prefix + name
                out[k][key] = out[k].get(key, 0.0) + (b - a) / 1e6
    return out


def total(parts: dict, name: str) -> float:
    """A request's ms of ``name`` and of every ``name:<program>``."""
    return sum(v for k, v in parts.items() if k == name or k.startswith(name + ":"))


def metrics(records: dict, windows: list, skip: int) -> dict:
    """``METRICS``: the median over the requests after the first ``skip``
    of each request's total (None where no request has the record);
    ``COUNTERS``: the kernel nodes the replays ran a request, the share
    of issued CG iterations that did work, and the share of the NN calls'
    tile pairs that the keep lists kept. All None where a ring dropped a
    mark."""
    names = list(METRICS) + list(COUNTERS)
    if records["dropped"] or not windows:
        return dict.fromkeys(names)
    parts = per_request(records, windows)[skip:]
    out = {}
    for name, record in METRICS.items():
        seen = [p for p in parts if any(k == record or k.startswith(record + ":") for k in p)]
        out[name] = statistics.median(total(p, record) for p in parts) if seen else None
    kernels = sum(v for k, v in records["counts"].items() if k.startswith("graph.kernels:"))
    out["graph_kernels_per_request"] = kernels / len(windows) if kernels else None
    run = records["counts"].get("cg.iters_run", 0)
    active = records["device_counts"].get("cg.iters_active")
    out["cg_active_pct"] = 100.0 * active / run if run and active is not None else None
    pairs = records["counts"].get("nn.tiles_total", 0)
    kept = records["device_counts"].get("nn.tiles_kept")
    out["nn_kept_pct"] = 100.0 * kept / pairs if pairs and kept is not None else None
    return out


def modes(walls: list, parts: list) -> dict:
    """The requests split at the widest gap between their sorted walls, and
    on either side the count, the wall's range and the median of each part
    (ms)."""
    if len(walls) < 2:
        return {}
    order = sorted(range(len(walls)), key=walls.__getitem__)
    cut = max(range(1, len(order)), key=lambda i: walls[order[i]] - walls[order[i - 1]])
    out = {}
    for label, idx in (("fast", order[:cut]), ("slow", order[cut:])):
        keys = sorted({k for i in idx for k in parts[i]})
        out[label] = {"requests": len(idx), "wall_ms": [walls[idx[0]], walls[idx[-1]]],
                      "median_ms": {k: statistics.median(parts[i].get(k, 0.0) for i in idx) for k in keys}}
    return out


def _line(xs: list, ys: list):
    """The least-squares line y = a + b x: (a, b)."""
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0
    return my - b * mx, b


def marks_vs_trace(records: dict, events: list, t0: int, t1: int) -> dict:
    """Each mark stamp of the records inside [t0, t1] against the start of
    the mark kernels of the profiler's trace there: paired in order where
    the counts agree, else each stamp with the nearest kernel. Gaps in µs;
    ``drift_us_per_s`` the slope of the signed gap (stamp − kernel) over
    the time since ``t0``, and ``detrended_*`` the gaps about that line."""
    stamps = sorted(x for _, _, a, b in records["marks"] for x in (a, b) if t0 <= x <= t1)
    kernels = sorted(s for name, s, _, _ in events if "mark_kernel" in name and t0 <= s <= t1)
    if not stamps or not kernels:
        return {"stamps": len(stamps), "kernels": len(kernels)}
    if len(stamps) == len(kernels):
        pairs = list(zip(stamps, kernels))
    else:
        pairs = []
        for a in stamps:
            k = bisect.bisect_left(kernels, a)
            near = [kernels[j] for j in (k - 1, k) if 0 <= j < len(kernels)]
            pairs.append((a, min(near, key=lambda x: abs(a - x))))
    signed = [(a - b) / 1e3 for a, b in pairs]
    gaps = [abs(g) for g in signed]
    at = [(b - t0) / 1e9 for _, b in pairs]
    a, slope = _line(at, signed)
    rest = [abs(g - a - slope * x) for g, x in zip(signed, at)]
    return {"stamps": len(stamps), "kernels": len(kernels), "paired_in_order": len(stamps) == len(kernels),
            "median_us": statistics.median(gaps), "max_us": max(gaps), "median_signed_us": statistics.median(signed),
            "drift_us_per_s": slope, "detrended_median_us": statistics.median(rest), "detrended_max_us": max(rest)}


def launch_order(records: dict, events: list = None, t0: int = None, t1: int = None) -> dict:
    """Whether the mapped clocks keep cause before effect: each replay's
    begin mark (a device time) less the start of its host launch span
    (``graphs.launch:*``, which the mark's own launch just precedes), in
    µs, paired in order; a mapping early by d shows as minima near −d.
    With ``events``, the same for the profiler's mark kernels in [t0, t1]
    against the launch spans there, each kernel paired in order with a
    stamp (the stream ran both in one order)."""
    launches = sorted(a for name, _, a, _ in records["spans"] if name.startswith("graphs.launch:"))
    begins = sorted(a for name, _, a, _ in records["marks"] if name == "graphs.replay")
    out = {}
    if launches and len(launches) == len(begins):
        d = [(m - h) / 1e3 for m, h in zip(begins, launches)]
        out["marks"] = {"replays": len(d), "min_us": min(d), "median_us": statistics.median(d)}
    if events is not None:
        # The trace's mark kernels paired in order with the stamps (both in
        # the order the stream ran them); a replay's begin takes its kernel.
        tagged = sorted(x for name, _, a, b in records["marks"]
                        for x in ((a, name == "graphs.replay"), (b, False)) if t0 <= x[0] <= t1)
        kernels = sorted(s for name, s, _, _ in events if "mark_kernel" in name and t0 <= s <= t1)
        window = [h for h in launches if t0 <= h <= t1]
        starts = [k for (_, begin), k in zip(tagged, kernels) if begin]
        if window and len(tagged) == len(kernels) and len(starts) == len(window):
            d = [(k - h) / 1e3 for k, h in zip(starts, window)]
            out["trace"] = {"replays": len(d), "min_us": min(d), "median_us": statistics.median(d)}
    return out


def stages(records: dict) -> dict:
    """Each ``graphs.replay`` device span and the device spans inside it:
    a fusion replay's five stages as a share of the replay (%), a
    Gauss-Newton replay's linearisation and CG (both must lie inside) and
    the rest of the step (replay less the two), and of that rest the lead
    (before the linearisation: the graph not yet running) and the tail
    (after CG: retraction, cost, selection), ms. A fusion replay's lead, ms,
    beside its share."""
    marks = sorted(records["marks"], key=lambda m: m[2])
    starts = [m[2] for m in marks]
    fuse, lead = [], []
    gn = {"linearise_ms": [], "cg_ms": [], "rest_ms": [], "lead_ms": [], "tail_ms": [], "outside": 0}
    for name, dev, a, b in marks:
        if name != "graphs.replay":
            continue
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        inner = {}
        for m in marks[lo:hi]:
            if m[0] != "graphs.replay" and m[1] == dev:
                inner.setdefault(m[0], []).append(m)
        if all(f"fuse.{s}" in inner for s in STAGES):
            fuse.append(100.0 * sum(m[3] - m[2] for s in STAGES for m in inner[f"fuse.{s}"]) / (b - a))
            lead.append((inner["fuse.alignment"][0][2] - a) / 1e6)
        if "gn.linearise" in inner and "gn.cg" in inner:
            lin, cg = inner["gn.linearise"], inner["gn.cg"]
            gn["outside"] += sum(not (a <= m[2] <= m[3] <= b) for m in lin + cg)
            lin_ms = sum(m[3] - m[2] for m in lin) / 1e6
            cg_ms = sum(m[3] - m[2] for m in cg) / 1e6
            gn["linearise_ms"].append(lin_ms)
            gn["cg_ms"].append(cg_ms)
            gn["rest_ms"].append((b - a) / 1e6 - lin_ms - cg_ms)
            gn["lead_ms"].append((lin[0][2] - a) / 1e6)
            gn["tail_ms"].append((b - cg[-1][3]) / 1e6)
    out = {}
    if fuse:
        out["fuse_share_pct"] = {"replays": len(fuse), "min": min(fuse), "median": statistics.median(fuse),
                                 "max": max(fuse)}
        out["fuse_lead_ms"] = {"min": min(lead), "median": statistics.median(lead), "max": max(lead)}
    if gn["cg_ms"]:
        out["gn_step"] = {"replays": len(gn["cg_ms"]), "outside": gn["outside"],
                          **{k: {"min": min(v), "median": statistics.median(v), "max": max(v)}
                             for k, v in gn.items() if k != "outside"}}
    return out


class Clocks:
    """The card's SM and memory clocks (MHz), performance state and clock
    event reasons, read through NVML after each request; an empty reading
    where NVML cannot be loaded."""

    def __init__(self, index: int):
        self.nvml = self.handle = None
        try:
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
            handle = ctypes.c_void_p()
            if nvml.nvmlInit_v2() == 0 and nvml.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)) == 0:
                self.nvml, self.handle = nvml, handle
        except (OSError, AttributeError):
            pass

    def read(self) -> dict:
        if self.nvml is None:
            return {}
        out = {}
        for name, kind in (("sm_mhz", 1), ("mem_mhz", 2)):  # NVML_CLOCK_SM, NVML_CLOCK_MEM
            mhz = ctypes.c_uint()
            if self.nvml.nvmlDeviceGetClockInfo(self.handle, kind, ctypes.byref(mhz)) == 0:
                out[name] = mhz.value
        state, reasons = ctypes.c_int(), ctypes.c_ulonglong()
        if self.nvml.nvmlDeviceGetPerformanceState(self.handle, ctypes.byref(state)) == 0:
            out["pstate"] = state.value
        if self.nvml.nvmlDeviceGetCurrentClocksThrottleReasons(self.handle, ctypes.byref(reasons)) == 0:
            out["clock_reasons"] = reasons.value
        return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profiled", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: a smoke run of the tool itself, nothing profiled")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gps_optimize_slam_tpu_torch.utils import profiling
    from portbench import harness
    from portbench.run import power_limits, sync_all

    t_start = time.perf_counter()
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    if args.device == "cpu":
        devices, sync = [torch.device("cpu")], (lambda: None)
    else:
        devices = [torch.device("cuda", i) for i in range(int(cfg["chips"]))]
        sync = sync_all(devices)
    n_prof = int(cell["traced_requests"]) if args.profiled is None else args.profiled
    n_prof = n_prof if args.tracer and args.device == "cuda" else 0
    spans = harness.Spans(sync)
    flow = harness.flow_class(cell["flow"])(cell, cfg, args.seed, devices, spans)
    if args.tracer:
        profiling.enable()
    flow.warm([])
    sync()
    if n_prof:
        with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's start-up, outside the window
            torch.zeros(1, device=devices[0]).add_(1)
            sync()
    gc.collect()
    gc.freeze()
    gc.disable()
    profiling.reset()
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    end = t0 + args.seconds
    clocks = Clocks(devices[0].index or 0) if args.device == "cuda" else None
    readings = []
    windows, walls, poses, t_last, k = [], [], 0, t0, 0
    prof = trace = None
    while time.perf_counter() < end or k < n_prof:
        profiled = k < n_prof
        if profiled and k == 0:
            prof = profile(activities=[ProfilerActivity.CUDA])
            sync()
            prof.start()
            trace = {"t0_ns": time.time_ns()}
        spans.mode = ("mark" if profiled else "sync") if n_prof else "off"
        a_ns, a = time.time_ns(), time.perf_counter()
        flow.request(k)
        b, b_ns = time.perf_counter(), time.time_ns()
        windows.append((a_ns, b_ns))
        walls.append(1e3 * (b - a))
        readings.append(clocks.read() if clocks else {})
        if profiled and k == n_prof - 1:
            sync()
            trace["t1_ns"] = time.time_ns()
            t_stop = time.perf_counter()
            prof.stop()
            end += time.perf_counter() - t_stop
        if b <= end:
            poses += flow.poses(k)
            t_last = b
        k += 1
    sync()
    gc.enable()
    gc.unfreeze()
    spans.mode = "off"
    records = profiling.records()
    profiling.disable()
    result = {"workload": args.workload, "seed": args.seed, "tracer": args.tracer, "profiled": n_prof,
              "card": power_limits() if args.device == "cuda" else "cpu", "setup_s": setup_s, "requests_sent": k,
              "poses_per_s": poses / (t_last - t0) if t_last > t0 else None,
              "wall_ms": {"median": statistics.median(walls), "p95": float(np.percentile(walls, 95))}}
    if args.tracer:
        parts = [{**c, **p} for c, p in zip(readings, per_request(records, windows))]
        result.update(metrics=metrics(records, windows, n_prof), dropped=records["dropped"],
                      calibration={str(d): r.calibration for d, r in profiling._RINGS.items()},
                      launch_order=launch_order(records),
                      unpaired=records["unpaired"], counts=records["counts"],
                      device_counts=records["device_counts"], stages=stages(records),
                      modes=modes(walls[n_prof:], parts[n_prof:]),
                      requests=[{"wall_ms": w, **p} for w, p in zip(walls, parts)])
    else:
        result["requests"] = [{"wall_ms": w, **c} for w, c in zip(walls, readings)]
    if prof is not None:
        trace.update(events=harness.device_events(prof), requests=n_prof)
        ctx = {"trace": trace, "chips": len(devices)}
        result["kernels_per_request"] = harness.metric_reader("kernels_per_request")(ctx)
        result["device_idle_pct"] = harness.metric_reader("device_idle_pct")(ctx)
        result["marks_vs_trace"] = marks_vs_trace(records, trace["events"], trace["t0_ns"], trace["t1_ns"])
        result["launch_order"] = launch_order(records, trace["events"], trace["t0_ns"], trace["t1_ns"])
        program = [(name, a, b) for name, _, a, b in records["spans"] if trace["t0_ns"] <= a <= trace["t1_ns"]]
        result["breakdown"] = harness.breakdown(trace, spans.marks + program)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    brief = {key: v for key, v in result.items() if key != "requests"}
    print(json.dumps(brief), flush=True)


if __name__ == "__main__":
    main()
