"""Timing and tracing helpers (port of
``gps_optimize_slam_tpu.utils.profiling``).

* ``wallclock``: host wall time of a call, the first call (kernel build and
  load included) apart from the warm ones, every CUDA device that holds an
  output synchronised before the clock stops.
* ``device_time``: sustained time a call, ``chain`` calls between two CUDA
  events (``time.perf_counter`` around a CPU run), so the host's dispatch
  of one call overlaps the device's work on the one before.
* ``trace``: a ``torch.profiler`` context, CPU and CUDA, that writes a
  Chrome trace.

PyTorch returns before the card finishes; synchronising the output's
devices is what makes a host clock read the device's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch


def _devices(result) -> set:
    """The CUDA devices of every tensor in ``result`` (tensors, NamedTuples,
    tuples, lists and dicts of them, any depth)."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.device.type == "cuda" else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        return set().union(*(_devices(x) for x in result)) if result else set()
    return set()


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result``."""
    for device in _devices(result):
        torch.cuda.synchronize(device)


def wallclock(fn: Callable, *args, runs: int = 10, **kwargs) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)``: ``{"compile_s", "median_ms", "min_ms"}``.
    ``compile_s`` is the first call, which builds and loads the kernels on
    first use; the others are ``runs`` warm calls."""
    t0 = time.perf_counter()
    synchronize(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        synchronize(fn(*args, **kwargs))
        times.append((time.perf_counter() - t0) * 1e3)
    return {"compile_s": compile_s, "median_ms": float(np.median(times)), "min_ms": float(np.min(times))}


def device_time(fn_of_i: Callable[[int], object], chain: int = 20, runs: int = 5) -> float:
    """Sustained milliseconds a call of ``fn_of_i(i)``: the median over
    ``runs`` of ``chain`` chained calls (i = 0..chain-1, so a caller can vary
    its inputs) between two CUDA events, divided by ``chain``; on the CPU
    (no CUDA output) between two ``perf_counter`` reads. One warm-up call
    first."""
    first = fn_of_i(0)
    devices = _devices(first)
    synchronize(first)
    times = []
    for _ in range(runs):
        if devices:
            device = next(iter(devices))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
            for i in range(chain):
                out = fn_of_i(i)
            stop.record(torch.cuda.current_stream(device))
            synchronize(out)
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            for i in range(chain):
                fn_of_i(i)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)) / chain


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present), written to ``log_dir/trace.json`` as a Chrome trace (open
    it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
