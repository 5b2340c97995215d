"""The port's timing and tracing helpers (``utils.profiling``) on the CPU:
the keys and signs of what they return, the chained calls ``device_time``
makes, and the Chrome trace ``trace`` writes. Times here are the CPU's and
say nothing of the card."""

import json

import torch

from gps_optimize_slam_tpu_torch.utils import profiling


def test_wallclock_keys_and_times():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return {"y": (x * scale).sum(), "z": [x + 1]}

    out = profiling.wallclock(fn, torch.ones(1000), runs=4, scale=2.0)
    assert set(out) == {"compile_s", "median_ms", "min_ms"}
    assert out["compile_s"] > 0 and 0 < out["min_ms"] <= out["median_ms"]
    assert len(calls) == 5  # the first call and four warm ones


def test_device_time_chains_calls_with_their_index():
    seen = []

    def fn_of_i(i):
        seen.append(i)
        return torch.full((100,), float(i)).cumsum(0)

    ms = profiling.device_time(fn_of_i, chain=6, runs=3)
    assert ms > 0
    assert seen == [0] + list(range(6)) * 3


def test_devices_are_read_from_nested_outputs():
    x = torch.zeros(2)
    assert profiling._devices((x, [x], {"a": x}, 3, None)) == set()  # CPU tensors need no synchronisation


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.arange(1000.0).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
