"""The harness driven end to end on the CPU at small sizes, its look for a
card skipped: the program's outputs come out correct against the plain
reference with each cell's limits; the control (the reference in float32
in the program's place) fails them; and with the timed path broken
underneath, ``correct`` comes out false: an answer altered where it is
produced, half of a batch left out, a Gauss-Newton step that returns its
state unchanged."""

import argparse
import contextlib
from unittest import mock

import pytest
import torch

from portbench import harness, run

SMALL = {
    "batch-kitti22": {"kind": "fleet", "lengths": [271, 601, 271, 601], "noise_m": 0.02, "variants": 3},
    "refine-kitti00": {"kind": "shuttle", "poses": 900, "outage_leg": 2, "noise_m": 0.02, "variants": 3},
}
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def small_cell(name):
    cell = harness.cell(name)
    cell["traffic_params"] = SMALL[name]
    return cell, harness.config(cell["config"])


def run_on_cpu(name, seed=2**31 + 5, fault=contextlib.nullcontext):
    cell, cfg = small_cell(name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.5, trace=0)
    devices = [torch.device("cpu")]
    with mock.patch.object(torch.cuda, "reset_peak_memory_stats", lambda d: None), \
            mock.patch.object(torch.cuda, "max_memory_allocated", lambda d: 0), \
            mock.patch.object(torch.cuda, "synchronize", lambda d=None: None), \
            mock.patch.object(torch.cuda, "get_device_name", lambda d=None: "cpu"), fault():
        return run.run_cell(args, cell, cfg, devices, harness.benchmark())


def test_small_mixes_cover_every_cell():
    assert sorted(SMALL) == sorted(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run_on_cpu(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and set(res["checks"]) == set(harness.cell(name)["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    cell, cfg = small_cell(name)
    flow = harness.flow_class(cell["flow"])(cell, cfg, 11, [torch.device("cpu")], harness.Spans())
    readings = flow.check(flow.control(0, torch.float32), torch.float64)
    assert any(v > cell["limits"][k] for k, v in readings.items()), readings


@contextlib.contextmanager
def altered_answer():
    """One fused position moved by 1 mm where the fusion produces it."""
    from gps_optimize_slam_tpu_torch.models import fusion

    real = fusion._fuse_core

    def fuse(*args, **kwargs):
        out = real(*args, **kwargs)
        pos = out.corrected_pos.clone()
        pos[..., 5, 0] += 1e-3
        return out._replace(corrected_pos=pos)

    with mock.patch.object(fusion, "_fuse_core", fuse):
        yield


@contextlib.contextmanager
def half_the_fleet():
    """The bucketing leaves out the second half of the drives."""
    from gps_optimize_slam_tpu_torch.parallel import batch as pbatch

    real = pbatch.bucket_by_length

    def bucket(slams, gts, gps, **kw):
        h = len(slams) // 2
        return real(slams[:h], gts[:h], gps[:h], **kw)

    with mock.patch.object(pbatch, "bucket_by_length", bucket):
        yield


@contextlib.contextmanager
def unchanged_step():
    """Each Gauss-Newton step returns its state and cost unchanged."""
    from gps_optimize_slam_tpu_torch.models import pose_graph

    with mock.patch.object(pose_graph, "_gn_step", lambda state, data, cg, damping, c_old: (state, c_old)):
        yield


@contextlib.contextmanager
def altered_refinement():
    """One refined position moved by 1 mm where the solve produces it."""
    from gps_optimize_slam_tpu_torch.models import pose_graph

    real = pose_graph.solve_pose_graph_checkpointed

    def solve(*args, **kwargs):
        res = real(*args, **kwargs)
        pos = res.state.positions.clone()
        pos[7, 1] += 1e-3
        return res._replace(state=res.state._replace(positions=pos))

    with mock.patch.object(pose_graph, "solve_pose_graph_checkpointed", solve):
        yield


FAULTS = [
    ("batch-kitti22", altered_answer), ("batch-kitti22", half_the_fleet),
    ("refine-kitti00", altered_answer), ("refine-kitti00", unchanged_step), ("refine-kitti00", altered_refinement),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_broken_timed_path_is_not_correct(name, fault):
    res = run_on_cpu(name, fault=fault)
    assert not res["correct"], res["checks"]
