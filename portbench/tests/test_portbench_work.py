"""The yardstick's arithmetic against hand counts, the pad waste of the
cells' own requests, the readers on a made-up trace, and the work and
launch counts that set-up and the window gather."""

import pytest
import torch

from portbench import harness, peaks
from portbench.traffic import generate


def test_scan_work_by_hand():
    # rts over 6 leaves of 4 rows of 1,001 float64: 6*4*1001 elements read
    # and written, 8 bytes each; 63 operations a combine, 1,000 a row.
    nbytes, flops = peaks.scan_work("rts", (6, 4, 1001), "float64")
    assert nbytes == 2 * 6 * 4 * 1001 * 8 and flops == 63 * 4 * 1000
    nbytes, flops = peaks.scan_work("add2", (2, 10), "float32")
    assert nbytes == 2 * 2 * 10 * 4 and flops == 2 * 9


def test_bound_takes_the_larger_term():
    assert peaks.bound_s(3.35e12, 0, "float64") == pytest.approx(1.0)
    assert peaks.bound_s(0, 34e12, "float64") == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 134e12, "float32") == pytest.approx(2.0)


def pad_waste(padded, real):
    return 100.0 * (padded - real) / real


def test_batch_pad_waste_is_the_bucketing_of_the_kitti_lengths():
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch

    (drives, _), = generate.requests({**generate.load("kitti22"), "variants": 1}, 7)
    buckets = pbatch.bucket_by_length([d[0] for d in drives], [d[1] for d in drives], [d[2] for d in drives],
                                      max_waste=2.0)
    shapes = [b.slam_times.shape for _, b in buckets]
    assert sorted(shapes) == [(2, 496), (5, 4984), (6, 2768), (9, 1208)]
    real = sum(int(b.n_slam.sum()) for _, b in buckets)
    assert real == 43_552 == 23_201 + 20_351  # KITTI odometry 00-10 and 11-21
    assert pad_waste(sum(r * n for r, n in shapes), real) == pytest.approx(22.59, abs=0.005)


def ctx_with(events, work=(), requests=1, chips=1, t0=0, t1=1000, name="scan_roofline_pct", launches=None):
    return {"trace": {"events": list(events), "requests": requests, "t0_ns": t0, "t1_ns": t1}, "work": list(work),
            "chips": chips, "metric_dir": f"{harness.HERE}/metrics/{name}", "launches": launches}


def test_scan_roofline_pairs_each_launch_with_its_own_call():
    read = harness.metric_reader("scan_roofline_pct")
    small, large = (6, 12, 272), (6, 5, 4984)  # two buckets' rts calls, 18x apart
    work = [("scan", "rts", small, "float64"), ("scan", "rts", large, "float64")]
    least = [peaks.bound_s(*peaks.scan_work("rts", shape, "float64"), "float64") for shape in (small, large)]
    launch = "void lookback_scan_kernel<(anonymous namespace)::RtsSuffix<double>, double, 4, true, 128>(double const*)"
    other = "void at::native::elementwise_kernel<128, 4>(int)"
    ns = [int(x * 1e9 * 4) for x in least]  # each launch at a quarter of its own roofline
    two = [(launch, 0, ns[0], 0), (other, ns[0], ns[0] + 5, 0), (launch, ns[0] + 5, ns[0] + 5 + ns[1], 0)]
    counted = {"scan_block/rts": 4}
    ctx = ctx_with(two + [(name, s + 10**9, e + 10**9, d) for name, s, e, d in two], work, requests=2,
                   launches=counted)
    assert read(ctx) == pytest.approx(25.0, rel=1e-3)
    # A launch missing from the trace, or counters that disagree with the
    # recorded calls, leave nothing to pair: no reading, not a shifted one.
    assert read({**ctx, "trace": {**ctx["trace"], "events": ctx["trace"]["events"][:-1]}}) is None
    assert read({**ctx, "launches": {"scan_block/rts": 3}}) is None
    assert read(ctx_with([(other, 0, 5, 0)], work, launches={"scan_block/rts": 2})) is None
    assert read({**ctx, "trace": None}) is None


def test_idle_and_kernels_and_breakdown():
    events = [("k1", 0, 100, 0), ("Memcpy HtoD (Pinned -> Device)", 50, 200, 0), ("k2", 600, 700, 0)]
    ctx = ctx_with(events, requests=2)
    assert harness.metric_reader("device_idle_pct")(ctx) == pytest.approx(70.0)
    assert harness.metric_reader("kernels_per_request")(ctx) == 1.0
    assert harness.metric_reader("copy_ms_per_request")(ctx) == pytest.approx(150 / 1e6 / 2)
    b = harness.breakdown(ctx["trace"], [("fuse", 0, 300), ("evaluate", 250, 650), ("inner", 350, 450)])
    assert b["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)", 150e-9]
    assert b["idle_gaps"][0] == ["inner", 400e-9] and b["idle_gaps"][1] == ["between requests", 300e-9]


def test_end_to_end_readers():
    ctx = {"latencies_s": [0.1, 0.2], "poses_completed": 1000, "window_to_last_s": 2.0,
           "peak_bytes": 2**31, "setup_s": 12.5}
    assert harness.metric_reader("poses_per_s")(ctx) == 500.0
    assert harness.metric_reader("request_p95_ms")(ctx) == pytest.approx(195.0)
    assert harness.metric_reader("request_p95_ms")({"latencies_s": []}) is None
    assert harness.metric_reader("peak_mem_gib")(ctx) == 2.0
    assert harness.metric_reader("setup_s")(ctx) == 12.5
    assert harness.metric_reader("graph_replay_pct")({"graphs": {"first_calls": 0, "captures": 1, "replays": 3}}) == 75.0
    assert harness.metric_reader("pad_waste_pct")({"pad": {"padded": 125, "real": 100}}) == 25.0


def test_recording_writes_the_declared_calls_and_restores_them():
    from gps_optimize_slam_tpu_torch.ops import scan

    real, counts = scan.scan_block, dict(scan.scan_block.launches)
    work = []
    with harness.recording(work, ["poses_per_s", "scan_roofline_pct"]):
        assert scan.scan_block is not real and scan.scan_block.launches is real.launches
        scan.associative_scan("add2", torch.zeros(2, 5, dtype=torch.float64))
        scan.associative_scan("max3", torch.zeros(3, 4, 7, dtype=torch.float32), reverse=True)
    assert work == [("scan", "add2", (2, 5), "float64"), ("scan", "max3", (3, 4, 7), "float32")]
    assert scan.scan_block is real and scan.scan_block.launches == counts
    # Metrics that declare no records leave the program as it is.
    with harness.recording(work, ["poses_per_s", "device_idle_pct"]):
        assert scan.scan_block is real
        scan.associative_scan("add2", torch.zeros(2, 5, dtype=torch.float64))
    assert len(work) == 2


def test_launch_counts_find_every_counter(monkeypatch):
    from gps_optimize_slam_tpu_torch.ops import kernels, scan
    from portbench.flows.common import FlowBase

    monkeypatch.setattr(kernels.pose_cg, "launches", 3)
    monkeypatch.setattr(kernels.keep_lists, "launches", 2)
    monkeypatch.setitem(scan.scan_block.launches, "rts", 5)
    monkeypatch.setitem(scan.scan_tiled.launches, "filter", 1)
    counts = FlowBase.launch_counts()
    # The keys a traced run printed before pose_cg joined keep their names.
    assert {"nn_keep", "nn_resident", "nn_grid", "ransac_counts", "pose_cg"} <= set(counts)
    assert counts["pose_cg"] == 3 and counts["nn_keep"] == 2
    assert counts["scan_block/rts"] == 5 and counts["scan_tiled/filter"] == 1
    scans = {f"scan_block/{op}" for op, c in scan.scan_block.launches.items() if c}
    scans |= {f"scan_tiled/{op}" for op, c in scan.scan_tiled.launches.items() if c}
    assert set(counts) == {"nn_keep", "nn_resident", "nn_grid", "ransac_counts", "pose_cg"} | scans
