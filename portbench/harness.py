"""The benchmark's machinery, shared by every cell: finding configurations,
cells, flows and metrics by name, the spans around the program's layers,
the recording of the work a request hands the kernels, and the device
trace and its reading (``run.py`` holds the measured window).

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``, whose
``kind`` is a module ``traffic/kinds/<kind>.py``), its CPU tests' small mix
(``small``), its flow (``flows/<flow>.py``, which builds, warms and drives
one entry of the program and compares a request's outputs with the plain
reference; the tests' faults of a flow are ``tests/faults/<flow>.py``) and
the limits of that comparison. A metric is a folder ``metrics/<name>/``
with ``metric.json`` and ``reader.py``, whose ``read(ctx)`` returns the
metric's value from what a run gathered, or None where it finds nothing to
read; a ``records.py`` there names the program calls whose work set-up
records for it, in the cells that report it. ``BENCHMARK.json`` alone lists which cells report which
metric. So a configuration, a cell, a kind of mix, a flow and a metric are
added as new files and new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import importlib
import importlib.util
import json
import os
import re
import resource
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gps_optimize_slam_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return load_json("workloads", f"{name}.json")


def config(name: str) -> dict:
    return load_json("configs", f"{name}.json")


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def flow_class(name: str):
    return importlib.import_module(f"portbench.flows.{name}").Flow


def _metric_module(name: str, file: str):
    """The module ``metrics/<name>/<file>.py``."""
    path = os.path.join(HERE, "metrics", name, f"{file}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{file}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>/reader.py``."""
    return _metric_module(name, "reader").read


def declared_records(metrics) -> list:
    """``[(module, function, note)]``: the program calls that the
    ``records.py`` files of the folders of ``metrics`` name (their
    ``RECORDS``), in the metrics' order; ``note(*args, **kwargs)`` makes a
    call's entry, a tuple whose first item names its kind."""
    out = []
    for name in metrics:
        if os.path.isfile(os.path.join(HERE, "metrics", name, "records.py")):
            out += _metric_module(name, "records").RECORDS
    return out


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The names of the metrics a run of cell ``name`` reports: its
    end-to-end metrics untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in group if "workloads" not in m or name in m["workloads"]]


def reported_metrics(bench: dict, name: str) -> list:
    """Every metric that some run of cell ``name`` reports."""
    return cell_metrics(bench, name, False) + cell_metrics(bench, name, True)


def kernel_patterns(metric_dir: str) -> list:
    """The kernel names listed in the metric folder's ``kernels*.txt`` files
    (one a line; ``#`` starts a comment)."""
    names = []
    for path in sorted(glob.glob(os.path.join(metric_dir, "kernels*.txt"))):
        with open(path) as f:
            names += [ln.split("#")[0].strip() for ln in f if ln.split("#")[0].strip()]
    return names


def matches(kernel: str, patterns) -> bool:
    return any(re.search(rf"\b{re.escape(p)}\b", kernel) for p in patterns)


def forbidden_loaded(modules) -> list:
    """The loaded modules whose top-level name is one the port's runs may
    not hold (JAX, its libraries and the JAX package), compared whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class Spans:
    """Host spans around the calls a flow makes into the program's layers.

    ``mode`` "off" records nothing (the untraced runs); "sync" synchronises
    the devices at both ends and records each span's milliseconds (a traced
    run's requests outside the trace); "mark" records the host's start and
    end time, in the trace's clock, without synchronising (the traced
    requests: what the host was doing)."""

    def __init__(self, sync=None):
        self.mode = "off"
        self.sync = sync or (lambda: None)
        self.ms: dict = {}
        self.marks: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.mode == "off":
            yield
            return
        if self.mode == "sync":
            self.sync()
        t0 = time.time_ns()
        try:
            yield
        finally:
            if self.mode == "sync":
                self.sync()
                self.ms.setdefault(name, []).append((time.time_ns() - t0) / 1e6)
            else:
                self.marks.append((name, t0, time.time_ns()))


# ---------------------------------------------------------------------------
# The work a request hands the kernels
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording(work: list, metrics):
    """Within it, each call of a program function that the ``records.py``
    of one of ``metrics`` names is also written to ``work``, as that
    record's note makes it of the call's arguments. A wrapped function's
    launch counts go on."""

    def wrap(real, note):
        @functools.wraps(real)
        def recorded(*args, **kwargs):
            work.append(note(*args, **kwargs))
            return real(*args, **kwargs)

        return recorded

    saved = []
    try:
        for module_name, name, note in declared_records(metrics):
            module = importlib.import_module(module_name)
            real = getattr(module, name)
            saved.append((module, name, real))
            setattr(module, name, wrap(real, note))
        yield work
    finally:
        for module, name, real in reversed(saved):
            if hasattr(real, "launches"):
                real.launches = getattr(module, name).launches
            setattr(module, name, real)


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------


def device_events(prof) -> list:
    """[(name, start_ns, end_ns, device)] of every device activity of a
    stopped profiler, on the host's wall clock (``time.time_ns``)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns(), e.device_index()))
    return out


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def union_ns(spans) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(events, device=None) -> float:
    return sum(e - s for s, e in union_ns([(s, e) for _, s, e, d in events if device is None or d == device]))


def breakdown(trace: dict, marks: list) -> dict:
    """The device operations with the most time, and the longest idle
    gaps of the devices (the union of their activity) named by the
    innermost span the host had open at the gap's middle (or "between
    requests")."""
    totals: dict = {}
    for name, s, e, _ in trace["events"]:
        key = name[:160]
        totals[key] = totals.get(key, 0.0) + (e - s) / 1e9
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    busy = union_ns([(s, e) for _, s, e, _ in trace["events"]])
    edges = [trace["t0_ns"]] + [x for iv in busy for x in iv] + [trace["t1_ns"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        open_ = [(a, n) for n, a, b in marks if a <= mid <= b]
        named.append([max(open_)[1] if open_ else "between requests", (e - s) / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# What the host and the card did over the window
# ---------------------------------------------------------------------------


def _cpu_times() -> list:
    """The machine's CPU time by kind (user, nice, system, idle, iowait,
    irq, softirq, steal), from the first line of /proc/stat; [] where it
    cannot be read."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return []


class HostReading:
    """Readings that explain a run's speed, printed beside its result and
    read by no metric: the share of the machine's CPU time that was busy
    and the share its hypervisor took (steal) over the window, this
    process's CPU seconds a second, the card's SM clock sampled after each
    request (NVML), and its throttle reasons at the window's close."""

    def __init__(self, index: int = 0):
        self.clocks: list = []
        self._nvml = self._handle = None
        try:
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
            handle = ctypes.c_void_p()
            if nvml.nvmlInit_v2() == 0 and nvml.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)) == 0:
                self._nvml, self._handle = nvml, handle
        except (OSError, AttributeError):
            pass

    def start(self) -> None:
        self._cpu0, self._ru0, self._t0 = _cpu_times(), resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()

    def sample(self) -> None:
        if self._nvml is not None:
            mhz = ctypes.c_uint()
            if self._nvml.nvmlDeviceGetClockInfo(self._handle, 1, ctypes.byref(mhz)) == 0:  # NVML_CLOCK_SM
                self.clocks.append(mhz.value)

    def stop(self) -> str:
        wall = time.perf_counter() - self._t0
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu_s = ru.ru_utime + ru.ru_stime - self._ru0.ru_utime - self._ru0.ru_stime
        parts = [f"this process {cpu_s / wall:.3f} CPU-s/s"]
        cpu1 = _cpu_times()
        if self._cpu0 and cpu1:
            d = [b - a for a, b in zip(self._cpu0, cpu1)]
            total = sum(d) or 1
            parts.append(f"machine busy {100.0 * (total - d[3] - d[4]) / total:.2f} % of {os.cpu_count()} CPUs, "
                         f"steal {100.0 * d[7] / total:.2f} %")
        if self.clocks:
            c = sorted(self.clocks)
            parts.append(f"SM clock min/median/max {c[0]}/{c[len(c) // 2]}/{c[-1]} MHz ({len(c)} samples)")
        if self._nvml is not None:
            reasons = ctypes.c_ulonglong()
            if self._nvml.nvmlDeviceGetCurrentClocksThrottleReasons(self._handle, ctypes.byref(reasons)) == 0:
                parts.append(f"throttle reasons {reasons.value:#x}")
            self._nvml.nvmlShutdown()
            self._nvml = None
        return "; ".join(parts)
