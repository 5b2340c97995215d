"""The port's timing helper and tracer (``utils.profiling``) on the CPU: the
keys and signs of what ``wallclock`` returns; the tracer off (nothing
recorded, the shared no-op), its host spans, its host mark ring (pairs,
wrap, drops, the same decoding as a card's ring) and its device counters
zeroed in place. Times here are the CPU's and say nothing of the card."""

import ast
import os
import threading
import time

import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tracer(monkeypatch):
    """The tracer's state fresh for one test (off, no rings, no records),
    the module's own restored afterwards."""
    monkeypatch.setattr(profiling, "_ON", False)
    for name in ("_SPANS", "_MARKS"):
        monkeypatch.setattr(profiling, name, [])
    for name in ("_COUNTS", "_COUNTER_SLOTS", "_RINGS"):
        monkeypatch.setattr(profiling, name, {})
    monkeypatch.setattr(profiling, "_LOST", {"dropped": 0, "unpaired": 0})
    yield profiling


def test_wallclock_keys_and_times():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return {"y": (x * scale).sum(), "z": [x + 1]}

    out = profiling.wallclock(fn, torch.ones(1000), runs=4, scale=2.0)
    assert set(out) == {"compile_s", "median_ms", "min_ms"}
    assert out["compile_s"] > 0 and 0 < out["min_ms"] <= out["median_ms"]
    assert len(calls) == 5  # the first call and four warm ones


def test_devices_are_read_from_nested_outputs():
    x = torch.zeros(2)
    assert profiling._devices((x, [x], {"a": x}, 3, None)) == set()  # CPU tensors need no synchronisation


def test_off_records_nothing_and_returns_the_shared_noop(tracer):
    assert not tracer.enabled()
    assert tracer.span("a") is tracer._NULL and tracer.span("a", "b") is tracer._NULL
    assert tracer.device_span("a", "cpu") is tracer._NULL
    with tracer.span("a"), tracer.device_span("b", torch.device("cpu")):
        tracer.count("c", 3)
        tracer.count_device("d", torch.tensor(2.0))
    assert tracer._RINGS == {} and tracer._COUNTER_SLOTS == {}  # nothing allocated
    assert tracer.records() == {"spans": [], "marks": [], "counts": {}, "device_counts": {}, "dropped": 0,
                                "unpaired": 0}


def test_spans_nest_and_carry_thread_ids_on_time_ns(tracer):
    tracer.enable()
    t0 = time.time_ns()
    with tracer.span("outer"):
        with tracer.span("inner", tracer.span):  # a function as the detail gives its name
            time.sleep(0.001)
        worker = threading.Thread(target=lambda: tracer.span("thread").__enter__().__exit__(None, None, None))
        worker.start()
        worker.join()
    t1 = time.time_ns()
    tracer.disable()
    spans = {name: (tid, a, b) for name, tid, a, b in tracer.records()["spans"]}
    assert set(spans) == {"outer", "inner:span", "thread"}
    (otid, o0, o1), (itid, i0, i1), (ttid, _, _) = spans["outer"], spans["inner:span"], spans["thread"]
    assert t0 <= o0 <= i0 < i1 <= o1 <= t1 and i1 - i0 >= 1_000_000
    assert otid == itid == threading.get_ident() != ttid


def test_host_ring_pairs_wraps_and_reports_drops(tracer, monkeypatch):
    """A ring of 8 slots: two nested device spans and a third pair up in
    order of their ends; the next ones wrap past slot 7 and still pair; 10
    marks without a read fill the ring and drop the last span's 2."""
    monkeypatch.setattr(tracer, "RING_SLOTS", 8)
    tracer.enable()
    cpu = torch.device("cpu")
    with tracer.device_span("a", cpu):
        with tracer.device_span("b", cpu):
            pass
    with tracer.device_span("c", cpu):
        pass
    rec = tracer.records()
    assert [m[0] for m in rec["marks"]] == ["b", "a", "c"] and {m[1] for m in rec["marks"]} == {-1}
    (_, _, a0, a1), (_, _, b0, b1) = rec["marks"][1], rec["marks"][0]
    assert a0 <= b0 <= b1 <= a1
    for name in ("d", "e", "f"):  # slots 6, 7, 0, 1, 2, 3
        with tracer.device_span(name, cpu):
            pass
    rec = tracer.records()
    assert [m[0] for m in rec["marks"]] == ["b", "a", "c", "d", "e", "f"] and rec["dropped"] == 0
    for k in range(5):  # 10 marks into 8 free slots: the last span's two marks dropped
        with tracer.device_span(f"g{k}", cpu):
            pass
    rec = tracer.records()
    tracer.disable()
    assert [m[0] for m in rec["marks"][6:]] == ["g0", "g1", "g2", "g3"]
    assert rec["dropped"] == 2 and rec["unpaired"] == 0
    assert all(a <= b for _, _, a, b in rec["marks"])


def test_an_end_mark_without_its_begin_is_counted_unpaired(tracer, monkeypatch):
    monkeypatch.setattr(tracer, "RING_SLOTS", 2)
    tracer.enable()
    cpu = torch.device("cpu")
    ring = tracer._ring(cpu)
    mark = tracer._mark_id("x")
    ring.mark(mark)
    ring.mark(mark)
    ring.mark(mark + 1)  # dropped: the ring is full
    tracer.records()
    ring.mark(mark + 1)
    ring.mark(mark + 1)
    ring.mark(mark + 1)  # dropped
    rec = tracer.records()
    tracer.disable()
    assert len(rec["marks"]) == 2 and rec["dropped"] == 2 and rec["unpaired"] == 0
    ring.mark(mark + 1)
    assert tracer.records()["unpaired"] == 1


def test_reset_zeroes_device_counters_in_place(tracer):
    tracer.enable()
    tracer.count_device("active", torch.tensor(True))
    tracer.count_device("active", torch.tensor(3))
    tracer.count_device("other", torch.tensor(0.5, dtype=torch.float64))
    tracer.count("host", 2)
    rec = tracer.records()
    assert rec["device_counts"] == {"active": 4.0, "other": 0.5} and rec["counts"] == {"host": 2}
    counters = tracer._ring("cpu").counters
    storage = counters.untyped_storage().data_ptr()
    tracer.reset()
    assert tracer._ring("cpu").counters is counters and counters.untyped_storage().data_ptr() == storage
    assert not counters.any()
    rec = tracer.records()
    tracer.disable()
    assert rec["device_counts"] == {"active": 0.0, "other": 0.0} and rec["counts"] == {} and not rec["spans"]


def test_threads_lose_no_record(tracer, monkeypatch):
    """Sixteen threads (more than the cores) at a 1-µs switch interval, each
    counting, spanning and marking on the shared CPU ring under names of its
    own: every count, span and mark pair is there."""
    import sys

    tracer.enable()
    cpu = torch.device("cpu")
    n_threads, n_iter = 16, 200

    def work(k):
        for _ in range(n_iter):
            tracer.count("shared")
            with tracer.span(f"s{k}"), tracer.device_span(f"m{k}", cpu):
                tracer.count_device(f"d{k % 4}", torch.tensor(1.0, dtype=torch.float64))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    rec = tracer.records()
    tracer.disable()
    assert rec["counts"] == {"shared": n_threads * n_iter} and rec["dropped"] == 0 and rec["unpaired"] == 0
    assert rec["device_counts"] == {f"d{j}": 4.0 * n_iter for j in range(4)}
    for k in range(n_threads):
        assert sum(m[0] == f"m{k}" for m in rec["marks"]) == n_iter
        assert sum(sp[0] == f"s{k}" for sp in rec["spans"]) == n_iter


def test_device_stamps_map_onto_the_host_clock_by_the_calibration_line(tracer):
    ring = tracer._Ring.__new__(tracer._Ring)
    stamps = np.array([1_000, 2_000_000_000], np.int64)
    ring.calibration = [(1_000, 5_000)]
    assert ring.to_host_ns(stamps).tolist() == [5_000, 2_000_004_000]  # one pair: the offset
    ring.calibration = [(0, 10), (1_000_000_000, 1_000_000_110)]  # the host clock 1e-7 faster
    assert ring.to_host_ns(stamps).tolist() == [1_010, 2_000_000_210]
    ring.calibration = []
    assert ring.to_host_ns(stamps) is stamps  # the CPU's stamps are host times


def test_nothing_in_the_port_or_its_benchmark_turns_the_tracer_on():
    """The tracer is on only where a caller calls ``enable()``: no module
    of the port, its command or its benchmark does (no environment variable
    or flag turns it on), so an untraced run replays untraced programs."""
    callers = []
    for top in ("gps_optimize_slam_tpu_torch", "portbench"):
        for root, _, files in os.walk(os.path.join(REPO, top)):
            for f in files:
                if not f.endswith(".py"):
                    continue
                path = os.path.join(root, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                callers += [path for node in ast.walk(tree) if isinstance(node, ast.Attribute)
                            and node.attr == "enable" and isinstance(node.value, ast.Name)
                            and node.value.id == "profiling"]
    assert callers == []
    import portbench.run  # noqa: F401
    from gps_optimize_slam_tpu_torch import cli, pipeline  # noqa: F401

    assert not profiling.enabled()
