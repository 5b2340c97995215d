"""The harness driven end to end on the CPU at small sizes, its look for a
card skipped: the program's outputs come out correct against the plain
reference with each cell's limits; the control (the reference in float32
in the program's place) fails them; and with the timed path broken
underneath, ``correct`` comes out false under each fault of the cell's flow
(``faults/<flow>.py``: in every flow an answer altered where the flow's
outputs are produced, and such as half of a batch left out, a
Gauss-Newton step that returns its state unchanged, a refined pose
moved). Each cell's small mix
is its ``small`` (``workloads/<cell>.json``)."""

import argparse
import contextlib
import importlib
from unittest import mock

import pytest
import torch

from portbench import harness, run
from portbench.traffic import generate

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def small_cell(name):
    cell = harness.cell(name)
    cell["traffic_params"] = cell["small"]
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


@pytest.mark.parametrize("name", CELLS)
def test_small_mixes_cover_every_cell(name):
    cell = harness.cell(name)
    assert "small" in cell, f"workloads/{name}.json has no small mix for the CPU tests"
    assert cell["small"]["kind"] == generate.load(cell["traffic"])["kind"]


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


def flow_faults(name):
    """The faults of cell ``name``: its flow's (``faults/<flow>.py``)."""
    return importlib.import_module(f"portbench.tests.faults.{harness.cell(name)['flow']}").FAULTS


FAULTS = [(name, fault) for name in CELLS for fault in flow_faults(name)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_broken_timed_path_is_not_correct(name, fault):
    res = run_on_cpu(name, fault=fault)
    assert not res["correct"], res["checks"]
