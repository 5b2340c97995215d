"""The reading of the tracer's records by ``tools/trace_requests.py`` on
made-up records: spans and marks into their requests, the per-layer
metrics (None once a ring dropped a mark), the two speeds of requests, the
marks against the profiler's mark kernels, and the stage spans inside their
replays."""

import importlib.util
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location("trace_requests",
                                               os.path.join(HERE, "..", "tools", "trace_requests.py"))
tr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tr)

MS = 1_000_000  # ns


def records(spans=(), marks=(), counts=None, device_counts=None, dropped=0):
    return {"spans": list(spans), "marks": list(marks), "counts": counts or {},
            "device_counts": device_counts or {}, "dropped": dropped, "unpaired": 0}


def fuse_replay(t, device=0, stage_ms=(1, 1, 2, 1, 4), gap_ms=0.1):
    """A fusion replay's device spans from t (ns): the replay, and its five
    stages one after another from ``gap_ms`` in, each ``stage_ms``."""
    out, at = [], t + int(gap_ms * MS)
    for s, ms in zip(tr.STAGES, stage_ms):
        out.append((f"fuse.{s}", device, at, at + int(ms * MS)))
        at += int(ms * MS)
    return [("graphs.replay", device, t, at + int(gap_ms * MS))] + out


def test_spans_and_marks_go_to_the_request_they_start_in():
    windows = [(0, 10 * MS), (20 * MS, 30 * MS)]
    rec = records(spans=[("graphs.launch:_fuse_core", 1, 1 * MS, 2 * MS), ("graphs.launch:_gn_step", 1, 3 * MS, 6 * MS),
                         ("sweep.stage", 1, 21 * MS, 22 * MS), ("sweep.stage", 1, 12 * MS, 13 * MS)],
                  marks=[("graphs.replay", 0, 9 * MS, 21 * MS)])
    parts = tr.per_request(rec, windows)
    assert parts == [{"graphs.launch:_fuse_core": 1.0, "graphs.launch:_gn_step": 3.0, "device:graphs.replay": 12.0},
                     {"sweep.stage": 1.0}]  # a span between requests belongs to none
    assert tr.total(parts[0], "graphs.launch") == 4.0 and tr.total(parts[0], "graphs") == 0.0


def test_metrics_are_medians_after_the_profiled_requests_and_none_once_a_mark_dropped():
    windows = [(k * 100 * MS, (k + 1) * 100 * MS - 1) for k in range(4)]
    spans = [("graphs.launch:_fuse_core", 1, k * 100 * MS, k * 100 * MS + (k + 1) * MS) for k in range(4)]
    spans += [("sweep.drain.rows", 1, k * 100 * MS + 50 * MS, k * 100 * MS + 50 * MS + 2 * MS) for k in range(4)]
    marks = [m for k in range(4) for m in fuse_replay(k * 100 * MS + 10 * MS)]
    counts = {"graph.kernels:_fuse_core": 4 * 7000, "cg.iters_run": 500}
    rec = records(spans, marks, counts, {"cg.iters_active": 125.0})
    got = tr.metrics(rec, windows, skip=1)
    assert got["graph_launch_ms"] == pytest.approx(3.0)  # requests 1-3: 2, 3, 4 ms
    assert got["sweep_host_ms.rows"] == pytest.approx(2.0) and got["sweep_host_ms.stage"] is None
    assert got["fuse_device_ms.ekf_rts"] == pytest.approx(4.0) and got["fuse_device_ms.ransac"] == pytest.approx(2.0)
    assert got["replay_device_ms"] == pytest.approx(9.2) and got["gn_device_ms.cg"] is None
    assert got["graph_kernels_per_request"] == 7000 and got["cg_active_pct"] == 25.0
    assert got["eval_device_ms.nn_ekf"] is None and got["nn_kept_pct"] is None
    assert set(got) == set(tr.METRICS) | set(tr.COUNTERS)
    assert tr.metrics(records(spans, marks, counts, dropped=1), windows, skip=1) == dict.fromkeys(got)


def test_evaluation_stages_and_the_kept_share_of_nn_tile_pairs():
    """Each request's evaluation stages on the device (``eval.*`` marks)
    are read as ``eval_device_ms.<stage>``; ``nn_kept_pct`` is the window's
    kept tile pairs (a device counter) over all tile pairs (a host counter),
    None without the latter."""
    windows = [(k * 100 * MS, (k + 1) * 100 * MS - 1) for k in range(3)]
    marks = []
    for k in range(3):
        at = k * 100 * MS + 10 * MS
        for stage, ms in zip(tr.EVAL_STAGES, (3, 2, 2 + k, 1)):
            marks.append((f"eval.{stage}", 0, at, at + ms * MS))
            at += ms * MS
    rec = records(marks=marks, counts={"nn.tiles_total": 3 * 9 * 4000}, device_counts={"nn.tiles_kept": 2700.0})
    got = tr.metrics(rec, windows, skip=0)
    assert got["eval_device_ms.nn_slam"] == pytest.approx(3.0) and got["eval_device_ms.ate"] == pytest.approx(1.0)
    assert got["eval_device_ms.nn_ekf"] == pytest.approx(3.0) and got["fuse_device_ms.ransac"] is None
    assert got["nn_kept_pct"] == pytest.approx(2.5)
    assert tr.metrics(records(marks=marks, device_counts={"nn.tiles_kept": 9.0}), windows, 0)["nn_kept_pct"] is None


def test_requests_split_into_two_speeds_at_the_widest_gap():
    walls = [50.0, 51.0, 62.0, 49.5, 60.0]
    parts = [{"device:graphs.replay": 40.0, "graphs.launch": w - 45.0} for w in walls]
    got = tr.modes(walls, parts)
    assert got["fast"]["requests"] == 3 and got["slow"]["requests"] == 2
    assert got["fast"]["wall_ms"] == [49.5, 51.0] and got["slow"]["wall_ms"] == [60.0, 62.0]
    assert got["slow"]["median_ms"] == {"device:graphs.replay": 40.0, "graphs.launch": 16.0}


def test_marks_pair_with_their_own_mark_kernels():
    marks = [("graphs.replay", 0, 1000, 9000), ("fuse.ransac", 0, 3000, 5000)]
    kernel = "void (anonymous namespace)::mark_kernel(unsigned long long*, long long*, int*, int, int)"
    events = [(kernel, s, s + 1500, 0) for s in (1010, 2990, 5030, 8960)] + [("gemm", 4000, 4500, 0)]
    got = tr.marks_vs_trace(records(marks=marks), events, 0, 10_000)
    assert got["paired_in_order"] and got["stamps"] == got["kernels"] == 4
    assert got["median_us"] == pytest.approx(0.02) and got["max_us"] == pytest.approx(0.04)
    got = tr.marks_vs_trace(records(marks=marks), events[:3], 0, 10_000)  # one kernel missing from the trace
    assert not got["paired_in_order"] and got["max_us"] == pytest.approx(3.97)


def test_stages_add_up_inside_their_replays():
    marks = fuse_replay(0) + fuse_replay(50 * MS, gap_ms=0.45)
    t = 100 * MS
    marks += [("graphs.replay", 0, t, t + 10 * MS), ("gn.linearise", 0, t + MS, t + 3 * MS),
              ("gn.cg", 0, t + 3 * MS, t + 8 * MS)]
    got = tr.stages(records(marks=marks))
    share = got["fuse_share_pct"]
    assert share["replays"] == 2 and share["max"] == pytest.approx(100 * 9 / 9.2)
    assert share["min"] == pytest.approx(100 * 9 / 9.9)
    gn = got["gn_step"]
    assert gn["replays"] == 1 and gn["outside"] == 0
    assert gn["linearise_ms"]["median"] == 2.0 and gn["cg_ms"]["median"] == 5.0 and gn["rest_ms"]["median"] == 3.0
    assert gn["lead_ms"]["median"] == 1.0 and gn["tail_ms"]["median"] == 2.0
    assert got["fuse_lead_ms"]["min"] == pytest.approx(0.1) and got["fuse_lead_ms"]["max"] == pytest.approx(0.45)


def test_launch_order_puts_each_replay_mark_after_its_launch_on_both_clocks():
    """Two replays launched at 1 and 11 ms (host spans); their begin marks
    mapped 5 and 8 µs later, the profiler's mark kernels 3 µs before the
    stamps; an inner mark pair between them is skipped by the pairing."""
    spans = [("graphs.launch:_gn_step", 1, t, t + 2 * MS) for t in (MS, 11 * MS)]
    marks = [("graphs.replay", 0, MS + 5_000, 9 * MS), ("gn.cg", 0, 2 * MS, 8 * MS),
             ("graphs.replay", 0, 11 * MS + 8_000, 19 * MS)]
    stamps = sorted(x for _, _, a, b in marks for x in (a, b))
    events = [("void (anonymous namespace)::mark_kernel(int)", x - 3_000, x - 2_000, 0) for x in stamps]
    got = tr.launch_order(records(spans, marks), events, 0, 20 * MS)
    assert got["marks"] == {"replays": 2, "min_us": 5.0, "median_us": 6.5}
    assert got["trace"] == {"replays": 2, "min_us": 2.0, "median_us": 3.5}
    drift = tr.marks_vs_trace(records(marks=marks), events, 0, 20 * MS)
    assert drift["median_signed_us"] == pytest.approx(3.0) and abs(drift["drift_us_per_s"]) < 1e-9
