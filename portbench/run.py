"""Run one cell of the port's benchmark on the cards of this machine.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. Set-up builds the cell's requests from the
seed, warms every shape they use (a first call that runs eagerly, a second
that captures the program, a third that replays it) and resets the peak
memory; then one client sends requests for ``--seconds``, each when the
one before has returned its results to the host. After the window the
outputs of one request, drawn from the seed, are compared with the plain
reference (``portbench/reference``) and each number is printed beside its
limit. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.

The window runs with Python's collector frozen and off, so that no
collection of set-up's objects falls inside it; each run prints on
standard error what the host and the card did over the window
(``harness.HostReading``) and its requests' latencies.

It exits non-zero, and prints no result, without a CUDA device or with
fewer than the cell asks for, and when a JAX module or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from portbench import harness  # noqa: E402

CACHE = os.path.join(harness.ROOT, "build", "portbench-cache")


def fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limits() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache of the run lives inside the checkout, at fixed paths.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"

    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    chips = int(cfg["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(f"the cell {args.workload} needs {chips} CUDA device(s); {n} present", 2)
    bench = harness.benchmark()
    devices = [torch.device("cuda", i) for i in range(chips)]
    result = run_cell(args, cell, cfg, devices, bench)
    found = harness.forbidden_loaded(sys.modules)
    if found:
        fail(f"modules of JAX or of the JAX package are loaded: {found}", 3)
    checks = result.pop("checks")
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r}) {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def sync_all(devices):
    import torch

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    return sync


def run_cell(args, cell: dict, cfg: dict, devices: list, bench: dict) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gps_optimize_slam_tpu_torch.utils import graphs

    sync = sync_all(devices)
    spans = harness.Spans(sync)
    flow = harness.flow_class(cell["flow"])(cell, cfg, args.seed, devices, spans)
    work: list = []
    flow.warm(work)
    sync()
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    # The request whose outputs are compared: drawn from the seed among the
    # first of each variant, or the last one sent where fewer completed.
    pick = np.random.default_rng([int(args.seed), 17]).integers(0, flow.variants)
    g0 = graphs.stats()
    n_traced = int(cell["traced_requests"]) if args.trace else 0
    lat, poses, attempted, failed, kept = [], 0, 0, 0, None
    trace = prof = None
    if n_traced:
        # The tracer's own start-up (CUPTI) belongs to set-up.
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=devices[0]).add_(1)
            sync()
    host = harness.HostReading(devices[0].index or 0)
    gc.collect()
    gc.freeze()
    gc.disable()
    host.start()
    t_start = time.perf_counter()
    setup_s = t_start - T_START
    end = t_start + args.seconds
    t_last, k = t_start, 0
    while time.perf_counter() < end or k < n_traced:
        traced = k < n_traced
        if traced and k == 0:
            prof = profile(activities=[ProfilerActivity.CUDA])
            sync()
            counts0 = flow.launch_counts()
            prof.start()
            trace = {"t0_ns": time.time_ns()}
        spans.mode = "off" if not args.trace else ("mark" if traced else "sync")
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = flow.request(k)
        except Exception:  # a request that fails is counted and shown, and the run is not correct
            traceback.print_exc()
            failed += 1
            out = None
        t1 = time.perf_counter()
        host.sample()
        if traced:
            print(f"portbench: traced request {k}: {1e3 * (t1 - t0):.1f} ms", file=sys.stderr)
        if traced and k == n_traced - 1:
            sync()
            trace["t1_ns"] = time.time_ns()
            counts1 = flow.launch_counts()
            t_stop = time.perf_counter()
            prof.stop()
            end += time.perf_counter() - t_stop  # the tracer's stop is not the window's
        if out is not None and t1 <= end:
            lat.append(t1 - t0)
            poses += flow.poses(k)
            t_last = t1
        if out is not None and kept is None and (k == pick or time.perf_counter() >= end):
            kept = flow.keep(k, out)
        k += 1
    sync()
    host_line = host.stop()
    gc.enable()
    gc.unfreeze()
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    g1 = graphs.stats()
    spans.mode = "off"
    ctx = {
        "cell": args.workload, "chips": len(devices), "setup_s": setup_s, "latencies_s": lat,
        "poses_completed": poses, "window_to_last_s": t_last - t_start, "peak_bytes": peak,
        "graphs": {k_: g1[k_] - g0[k_] for k_ in ("first_calls", "captures", "replays")},
        "pad": flow.padding(), "work": work, "spans": spans.ms, "marks": spans.marks, "trace": None,
        "launches": None,
    }
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]), "count": len(devices),
              "memory_peak_bytes": int(peak)}
    if prof is not None and "t1_ns" in trace:
        trace.update(events=harness.device_events(prof), requests=n_traced)
        ctx["trace"] = trace
        window_s = (trace["t1_ns"] - trace["t0_ns"]) / 1e9
        device["busy_s"] = sum(harness.busy_ns(trace["events"], d.index) for d in devices) / len(devices) / 1e9
        device["window_s"] = window_s
        counts = {key: n - counts0.get(key, 0) for key, n in counts1.items()}
        counts = {key: n for key, n in counts.items() if n}
        ctx["launches"] = counts
        print(f"portbench: traced {n_traced} requests, {len(trace['events'])} device events; launch counters "
              f"{counts}", file=sys.stderr)
    names = harness.cell_metrics(bench, args.workload, bool(args.trace))
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in names:
        ctx["metric_dir"] = os.path.join(harness.HERE, "metrics", name)
        value = harness.metric_reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if ctx["trace"] is not None:
        result["breakdown"] = harness.breakdown(ctx["trace"], spans.marks)
    del ctx, prof, trace
    print(f"portbench: {power_limits()}; {k} requests sent, {len(lat)} completed in the window; "
          f"set-up {setup_s:.3f} s", file=sys.stderr)
    if lat:
        q = np.percentile(np.asarray(lat) * 1e3, [5, 50, 95, 100])
        print(f"portbench: request ms p5/p50/p95/max {q[0]:.3f}/{q[1]:.3f}/{q[2]:.3f}/{q[3]:.3f}", file=sys.stderr)
    print(f"portbench: host over the window: {host_line}", file=sys.stderr)

    # The comparison with the plain reference, after the window, with the
    # program's state freed.
    flow.close()
    gc.collect()
    torch.cuda.empty_cache()
    checks = {}
    t_check = time.perf_counter()
    if kept is not None:
        limits = cell["limits"]
        for name, value in flow.check(kept, torch.float64).items():
            checks[name] = [float(value), float(limits[name])]
    print(f"portbench: the reference's comparison took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    result["correct"] = bool(kept is not None and failed == 0 and checks
                             and all(v <= lim for v, lim in checks.values()))
    result["checks"] = checks
    return result


if __name__ == "__main__":
    main()
