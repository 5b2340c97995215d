"""The NCLT long-term cell's own pieces on the CPU: the ``resampled`` kind of
traffic (the 10-Hz poses kept at their own times, one Sim(3) for every
replica, no turn near the sharp-turn gate, outages where ``outage_every``
puts them), the reference's evaluation against brute force, the program's
evaluation against the reference on the same fused drive, the
``nn_roofline_pct`` reader on a made-up trace, the ``longlog_ms`` readers,
what set-up records for the NN metric, and the digests of the cell's mixes,
pinned when the kind was written."""

import hashlib
import json
import math

import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

from portbench import checks, harness, peaks
from portbench.flows import longlog_eval
from portbench.reference import evaluation as ref_eval
from portbench.reference import fusion as ref
from portbench.traffic import generate
from portbench.traffic.kinds import resampled

CELL = "longlog-nclt27"
MIXES = {
    ("nclt27", 7): "a7d0ccd4d415e5d629f32e72d13bf2e67db71ef8dfd402e0eab1e3a647e1c3ec",
    ("nclt27", 2**31 + 77): "ed018594c6f715488222ec469e614e083d4a56c50bd40b490a7a4a7065142d79",
}
SMALL = "5df2e1b845a38d6ee2ade8fbbfafc5da04faa0f51ee41d482b8ac68afd57c849"


def mix_digest(params, seed):
    """The digest of every array of a mix's requests, as
    ``test_portbench_pinned.py`` takes it."""
    h = hashlib.sha256()
    for drives, seeds in generate.requests(params, seed):
        for slam, gt, gp in drives:
            for a in (slam["timestamps"], slam["positions"], slam["quaternions"], gt, gp):
                h.update(str((a.dtype.str, a.shape)).encode())
                h.update(a.tobytes())
        h.update(json.dumps(seeds).encode())
    return h.hexdigest()


def yaw(q):
    x, y, z, w = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


# ---------------------------------------------------------------------------
# The resampled kind
# ---------------------------------------------------------------------------


def test_the_ten_hz_poses_are_kept_at_their_own_times():
    """The resampling passes through seq-04's own poses at their own times;
    the grid is 0.01 s over seq-04's span (2,811 poses), each grid pose
    between its two neighbours; the GNSS keeps seq-04's own fix times."""
    g = generate.golden()
    pos, quat = resampled.pose_at(g["slam_times"])
    np.testing.assert_allclose(pos, g["slam_pos"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(quat, g["slam_quat"] / np.linalg.norm(g["slam_quat"], axis=1, keepdims=True),
                               rtol=0, atol=1e-15)
    t, p, q = resampled.replica(100.0)
    assert len(t) == 2811 and t[0] == g["slam_times"][0] and np.allclose(np.diff(t), 0.01, rtol=0, atol=1e-12)
    assert t[-1] <= g["slam_times"][-1]
    j = np.searchsorted(g["slam_times"], t, side="right") - 1
    j = np.minimum(j, len(g["slam_times"]) - 2)
    lo, hi = np.minimum(g["slam_pos"][j], g["slam_pos"][j + 1]), np.maximum(g["slam_pos"][j], g["slam_pos"][j + 1])
    assert np.all(p >= lo - 1e-9) and np.all(p <= hi + 1e-9)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, rtol=0, atol=1e-15)
    period, _, _ = resampled.chain(100.0)
    slam, gt, _ = resampled.resampled_sequence(3 * 2811, 100.0, 20, np.random.default_rng(0), 0.0)
    np.testing.assert_array_equal(gt, np.concatenate([g["gps_times"] + k * period for k in range(3)]))
    assert slam["timestamps"].shape == (3 * 2811,)


def test_one_sim3_fits_every_replica():
    """Without noise, the Sim(3) fitted to the first replica's poses and
    GNSS fits every later replica as well as the first: the chaining moves
    the GNSS by the golden Sim(3)'s image of the SLAM shift."""
    slam, gt, gp = resampled.resampled_sequence(6 * 2811, 100.0, 4, np.random.default_rng(1), 0.0)
    aligned, valid = ref.align(slam["timestamps"], gt, gp, np.ones(len(gt), bool), 5.0)
    first = valid & (np.arange(len(valid)) < 2811)
    scale, R, t = ref.umeyama(slam["positions"], np.nan_to_num(aligned), first, torch.float64)
    res = ref.residuals(slam["positions"], np.nan_to_num(aligned), scale, R, t)
    per_replica = [res[valid & (np.arange(len(valid)) // 2811 == k)].max() for k in (0, 1, 2, 4, 5)]
    # Far inside the 4-m threshold, and as far in the sixth replica, ~2 km
    # on, as in the first (GNSS shifted by the SLAM shift itself puts the
    # sixth 2.8 km off).
    assert max(per_replica) < 0.5 and max(per_replica) - min(per_replica) < 0.05, per_replica


def test_no_turn_reaches_the_sharp_turn_gate_at_full_size():
    """Every pose pair of a full-size log, the joints between replicas
    included, turns well under the RTS stage's 45 °/s gate (seq-04's own
    5.4 °/s): re-timed ten times faster it would reach 54 °/s."""
    params = generate.load("nclt27")
    slam, _, _ = resampled.resampled_sequence(int(params["poses"]), float(params["rate_hz"]),
                                              int(params["outage_every"]), np.random.default_rng(2), 0.02)
    t, y = slam["timestamps"], yaw(slam["quaternions"])
    dy = np.arctan2(np.sin(np.diff(y)), np.cos(np.diff(y)))
    rate = np.degrees(np.abs(dy) / np.diff(t))
    assert len(t) == 465_333 and np.all(np.diff(t) > 0)
    assert rate.max() < 6.0 < 45.0
    g = generate.golden()
    fast = np.degrees(np.abs(np.diff(np.unwrap(yaw(g["slam_quat"])))) / (np.diff(g["slam_times"]) / 10))
    assert fast.max() > 45.0


@pytest.mark.parametrize("every", [2, 3, 20])
def test_outages_fall_where_outage_every_puts_them(every):
    """Replicas ``every`` - 1, 2·``every`` - 1, ... carry no GNSS, every
    other replica all of seq-04's fixes; the first outage lies after the
    Sim(3) window's 180 s at the mix's ``outage_every``."""
    n_rep = 2811
    reps = 2 * every + 1
    slam, gt, _ = resampled.resampled_sequence(reps * n_rep, 100.0, every, np.random.default_rng(3), 0.02)
    period, _, _ = resampled.chain(100.0)
    rep_of_fix = np.floor((gt - generate.golden()["gps_times"][0] + 1e-9) / period).astype(int)
    counts = np.bincount(rep_of_fix, minlength=reps)
    n_fix = len(generate.golden()["gps_times"])
    for k in range(reps):
        assert counts[k] == (0 if (k + 1) % every == 0 else n_fix), (k, counts[k])
    if every == generate.load("nclt27")["outage_every"]:
        assert (every - 1) * period > 180.0 + 2 * period


# ---------------------------------------------------------------------------
# The reference's evaluation
# ---------------------------------------------------------------------------


def brute_force_report(slam, fused):
    """The five evaluations by brute force (every pair's distance)."""
    g = ref_eval.gate(slam["timestamps"], fused["valid"])
    track = fused["aligned"][g]
    out = {}
    for name, traj in (("slam", slam["positions"]), ("sim3", fused["sim3_pos"]), ("ekf", fused["pos"])):
        out[f"nn_{name}"] = cdist(traj[g], track).min(1)
    for name, traj in (("sim3", fused["sim3_pos"]), ("ekf", fused["pos"])):
        out[f"ate_{name}"] = np.linalg.norm(traj[g] - track, axis=1)
    return {k: {"mean": v.mean(), "median": np.median(v), "rmse": np.sqrt((v * v).mean()), "max": v.max(),
                "count": len(v)} for k, v in out.items()}


def small_drive(n=3000, seed=4):
    slam, gt, gp = resampled.resampled_sequence(n, 100.0, 2, np.random.default_rng(seed), 0.02)
    return slam, gt, gp, checks.reference_drive(slam, gt, gp, harness.config("nclt-longterm"), torch.float64)


def test_reference_evaluation_equals_brute_force():
    slam, _, _, fused = small_drive()
    got, want = ref_eval.evaluate(slam, fused), brute_force_report(slam, fused)
    assert list(got) == list(ref_eval.EVALUATIONS)
    for name in ref_eval.EVALUATIONS:
        assert got[name]["count"] == want[name]["count"] > 2000
        for stat in ("mean", "median", "rmse", "max"):
            assert abs(got[name][stat] - want[name][stat]) <= 1e-12, (name, stat)
    # No gated pose: the program's conventions.
    none = ref_eval.evaluate(slam, {**fused, "valid": np.zeros_like(fused["valid"])})
    assert none["nn_ekf"] == {"mean": 0.0, "median": float("inf"), "rmse": 0.0, "max": float("-inf"), "count": 0}


def test_program_evaluation_equals_the_reference_on_the_same_fused_drives():
    """``evaluate_batch`` on the CPU (the plain NN, a batch of two drives of
    other lengths, padded) against the reference's evaluation of the same
    fused drives: every statistic within 1e-12 m, every count equal; and
    ``eval_gaps`` reads those gaps."""
    from gps_optimize_slam_tpu_torch.models import fusion
    from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch
    from gps_optimize_slam_tpu_torch.parallel import mesh

    drives = [small_drive(3000, 5), small_drive(2500, 6)]
    b = pbatch.pad_batch([d[0] for d in drives], [d[1] for d in drives], [d[2] for d in drives])

    def padded(key, width):
        out = np.zeros((2, b.slam_times.shape[1], width))
        for i, d in enumerate(drives):
            out[i, : len(d[3][key])] = d[3][key].reshape(len(d[3][key]), width)
        return torch.as_tensor(out)

    valid = padded("valid", 1)[..., 0].bool()
    zeros = torch.zeros(2, b.slam_times.shape[1], 3, dtype=torch.float64)
    outputs = fusion.FusionOutputs(
        corrected_pos=padded("pos", 3), corrected_quat=zeros, sim3_pos=padded("sim3_pos", 3), sim3_quat=zeros,
        sim3=Sim3(*(torch.zeros(2) for _ in Sim3._fields)), sim3_inliers=valid, aligned_gps=padded("aligned", 3),
        gps_valid=valid, ok=torch.ones(2, dtype=torch.bool))
    ev = mesh.evaluate_batch(b, outputs)
    for i, (slam, _, _, fused) in enumerate(drives):
        got = {name: {stat: getattr(getattr(ev, name), stat)[i].item() for stat in ref_eval.STATS}
               for name in ref_eval.EVALUATIONS}
        want = ref_eval.evaluate(slam, fused)
        gaps = longlog_eval.eval_gaps(got, want)
        assert gaps["eval_count_diff"] == 0 and gaps["eval_m"] <= 1e-12, gaps
        worse = {**got, "ate_ekf": {**got["ate_ekf"], "median": got["ate_ekf"]["median"] + 1e-6,
                                    "count": got["ate_ekf"]["count"] - 2}}
        assert longlog_eval.eval_gaps(worse, want) == {"eval_m": pytest.approx(1e-6, rel=1e-3), "eval_count_diff": 2}


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

K3 = "void (anonymous namespace)::nn_kernel<double, 64>(double const*, int, double const*, int const*, int)"
KEEP = "void (anonymous namespace)::keep_lists_kernel(double const*, int, int, int, int, int, int*, int*)"
BOXES = "void (anonymous namespace)::segment_boxes_kernel<double>(double const*, int, int, int)"
OTHER = "void at::native::vectorized_elementwise_kernel<4>(int)"


def nn_ctx(events, work, requests=1, launches=None):
    return {"trace": {"events": list(events), "requests": requests, "t0_ns": 0, "t1_ns": 10**12},
            "work": list(work), "chips": 1, "launches": launches,
            "metric_dir": f"{harness.HERE}/metrics/nn_roofline_pct"}


def test_nn_bytes_by_hand():
    read = harness._metric_module("nn_roofline_pct", "reader")
    # 27 rows of 465,336 float64 queries and candidates: 24 bytes a
    # coordinate triple each side, a mask byte, an 8-byte minimum.
    assert read.nn_bytes((27, 465_336, 3), (27, 465_336, 3), "float64") == 27 * 465_336 * (24 + 24 + 1 + 8)
    assert read.nn_bytes((100, 3), (300, 3), "float32") == 100 * 12 + 300 * 12 + 300 + 100 * 4


def test_nn_roofline_pairs_calls_and_never_passes_100():
    reader = harness._metric_module("nn_roofline_pct", "reader")
    shape = (27, 465_336, 3)
    calls = [("nn", shape, shape, "float64")] * 3
    least_ns = 1e9 * reader.nn_bytes(shape, shape, "float64") / peaks.PEAK_BYTES_PER_S

    def trace(per_call_ns, requests):
        events, t = [], 0
        for _ in range(requests * 3):
            for name, ns in ((BOXES, per_call_ns[0]), (KEEP, per_call_ns[1]), (OTHER, 500), (K3, per_call_ns[2])):
                events.append((name, t, t + math.ceil(ns), 0))
                t += math.ceil(ns) + 10
        return events

    # Every kernel of a call at a third of its bound: 100 % exactly, not more.
    at_bound = [least_ns / 3] * 3
    ctx = nn_ctx(trace(at_bound, 2), calls, requests=2, launches={"nn_resident": 6, "nn_keep": 6})
    assert reader.read(ctx) == pytest.approx(100.0, rel=1e-4) and reader.read(ctx) <= 100.0
    # At four times the bound: 25 %.
    ctx = nn_ctx(trace([4 * x for x in at_bound], 2), calls, requests=2, launches={"nn_resident": 4, "nn_grid": 2})
    assert reader.read(ctx) == pytest.approx(25.0, rel=1e-3)
    # Counters, or K3/K4 launches in the trace, that differ from the calls:
    # no reading.
    assert reader.read({**ctx, "launches": {"nn_resident": 5}}) is None
    assert reader.read(nn_ctx(trace(at_bound, 2)[:-1], calls, requests=2, launches={"nn_resident": 6})) is None
    assert reader.read(nn_ctx(trace(at_bound, 1), [], launches={})) is None
    assert reader.read({**ctx, "trace": None}) is None


def test_longlog_span_readers():
    spans = {"stage": [5.0, 7.0, 6.0], "fuse": [400.0], "evaluate": [90.0, 110.0], "fetch": [30.0, 40.0]}
    want = {"stage": 6.0, "fuse": 400.0, "evaluate": 100.0, "fetch": 35.0}
    for stage, value in want.items():
        assert harness.metric_reader(f"longlog_ms.{stage}")({"spans": spans}) == value
        assert harness.metric_reader(f"longlog_ms.{stage}")({"spans": {}}) is None


def test_set_up_records_each_nn_call_of_the_evaluation():
    """The small mix's first request records the evaluation's three NN
    calls (``ops.metrics.nn_min_dist2``: the name the evaluation calls), each
    a row a log of padded queries against padded candidates, and the scans
    beside them."""
    cell = harness.cell(CELL)
    cell["traffic_params"] = cell["small"]
    flow = harness.flow_class(cell["flow"])(cell, harness.config(cell["config"]), 2**31 + 5, [torch.device("cpu")],
                                           harness.Spans())
    work = []
    with harness.recording(work, ["nn_roofline_pct"]):
        flow.request(0)
    flow.close()
    n = flow.batches[0].slam_times.shape[1]
    assert work == [("nn", (2, n, 3), (2, n, 3), "float64")] * 3 and n == 1200


# ---------------------------------------------------------------------------
# The traffic stays as it was
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mix,seed", sorted(MIXES), ids=lambda x: str(x))
def test_mix_arrays_unchanged(mix, seed):
    assert mix_digest(generate.load(mix), seed) == MIXES[mix, seed]


def test_small_mix_arrays_unchanged():
    assert mix_digest(harness.cell(CELL)["small"], 2**31 + 5) == SMALL
