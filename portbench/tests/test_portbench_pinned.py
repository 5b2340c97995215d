"""The traffic stays as it was: digests of every array of both mixes'
requests at two seeds and of each cell's small mix, pinned from the
benchmark as it stood before mixes' kinds became modules of their own.
What set-up records of a cell's small mix on the CPU holds what its
metrics' readers take: the entries of its metrics' records, and no other
(the program's sequence of calls is the program's, and is not pinned)."""

import hashlib
import json

import pytest
import torch

from portbench import harness
from portbench.traffic import generate

MIXES = {
    ("kitti22", 7): "9db068e30b3724ee42720c96ccb28f31684b226d2f0054bb40ee1df4a304485d",
    ("kitti22", 2**31 + 77): "56acd4c57cd720980381876973f0d73843a62aa332310817f1bc619dee69a53a",
    ("shuttle4541", 7): "5ee0656a71167b9c50bb25866c6246c931204e47ef922463368f4ec9356301f6",
    ("shuttle4541", 2**31 + 77): "6738db603c7f11dcaafb061ff4eb858c74f19b458a4c7a45cb7b413545dddf14",
}
SMALL = {
    "batch-kitti22": "9555f081ccc81911fcd4fada44b49bf6ed2d78dfb85a35523618310bcac58bf3",
    "refine-kitti00": "92a06eaceaeaddc25af5aa392ab844acd703d3f88aea87926d6bc6d30a901ed3",
}


def mix_digest(params, seed):
    h = hashlib.sha256()
    for drives, seeds in generate.requests(params, seed):
        for slam, gt, gp in drives:
            for a in (slam["timestamps"], slam["positions"], slam["quaternions"], gt, gp):
                h.update(str((a.dtype.str, a.shape)).encode())
                h.update(a.tobytes())
        h.update(json.dumps(seeds).encode())
    return h.hexdigest()


@pytest.mark.parametrize("mix,seed", sorted(MIXES), ids=lambda x: str(x))
def test_mix_arrays_unchanged(mix, seed):
    assert mix_digest(generate.load(mix), seed) == MIXES[mix, seed]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_mix_arrays_unchanged(name):
    assert mix_digest(harness.cell(name)["small"], 2**31 + 5) == SMALL[name]


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_recorded_work_is_what_the_cells_metrics_read(name):
    from gps_optimize_slam_tpu_torch.ops import scan

    cell = harness.cell(name)
    cell["traffic_params"] = cell["small"]
    flow = harness.flow_class(cell["flow"])(cell, harness.config(cell["config"]), 2**31 + 5,
                                           [torch.device("cpu")], harness.Spans())
    metrics = harness.reported_metrics(harness.benchmark(), name)
    work = []
    flow.warm(work, metrics)
    flow.close()
    if "scan_roofline_pct" not in metrics:
        assert all(item[0] != "scan" for item in work)
        return
    scans = [item for item in work if item[0] == "scan"]
    assert scans, "set-up recorded no scan call for scan_roofline_pct to pair"
    for kind, op, shape, dtype in scans:
        assert op in scan.OPS and dtype in ("float32", "float64")
        assert isinstance(shape, tuple) and shape and all(isinstance(n, int) and n > 0 for n in shape)
