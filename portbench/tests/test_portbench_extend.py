"""A configuration, a cell, a kind of traffic mix, a flow with its faults and
a per-layer metric that records program calls go into a copy of the
benchmark as new files and new entries in ``BENCHMARK.json`` alone: the
copy's own tests (this file's aside) all pass with the new cell among
them (the flow's altered answer planted in a function of its own, not the
fusion's core), set-up records the new metric's calls in the new cell
alone while the other cells record what they did without it, and no file
that was there before changes. A cell without a small mix for the CPU tests fails
discovery."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

CELL, CONFIG, KIND, MIX, FLOW, METRIC = "probe-cell", "probe-config", "probe_reversed", "probe-mix", "probe_flow", \
    "probe_fusions"

NEW_FILES = {
    f"traffic/kinds/{KIND}.py": '''"""A probe kind: the fleet's drives, longest first."""

from portbench.traffic.kinds import fleet


def drives(params, rng):
    lengths = sorted((int(n) for n in params["lengths"]), reverse=True)
    return [fleet.replica_sequence(n, rng, float(params["noise_m"])) for n in lengths]
''',
    f"traffic/{MIX}.json": json.dumps({"kind": KIND, "lengths": [271, 601, 271], "noise_m": 0.02, "variants": 3}),
    f"flows/{FLOW}.py": '''"""A probe flow: the fleet's buckets under a name of its own."""

from portbench.flows import fleet_buckets


class Flow(fleet_buckets.Flow):
    pass
''',
    f"tests/faults/{FLOW}.py": '''"""The probe flow's faults: its own altered answer, planted in the rows
that fuse_buckets hands the flow, and the fleet's half left out."""

import contextlib
from unittest import mock

import numpy as np

from portbench.tests.faults.fleet_buckets import half_the_fleet


@contextlib.contextmanager
def altered_answer():
    """The first drive's sixth fused position moved by 1 mm in its row."""
    from gps_optimize_slam_tpu_torch.parallel import mesh

    real = mesh.fuse_buckets

    def fuse(*args, **kwargs):
        rows = list(real(*args, **kwargs))
        pos = np.array(rows[0].corrected_pos, copy=True)
        pos[5, 0] += 1e-3
        rows[0] = rows[0]._replace(corrected_pos=pos)
        return rows

    with mock.patch.object(mesh, "fuse_buckets", fuse):
        yield


FAULTS = [altered_answer, half_the_fleet]
''',
    f"metrics/{METRIC}/metric.json": json.dumps({"unit": "calls", "better": "lower", "source": "program_counter",
                                                 "layer": "Batching (parallel.batch, parallel.mesh)",
                                                 "moves": "poses_per_s"}),
    f"metrics/{METRIC}/records.py": '''"""The calls probe_fusions reads: each fuse_buckets, with its buckets."""

MESH = "gps_optimize_slam_tpu_torch.parallel.mesh"


def note(buckets, *rest, **kwargs):
    return ("fuse_buckets", len(buckets))


RECORDS = [(MESH, "fuse_buckets", note)]
''',
    f"metrics/{METRIC}/reader.py": '''"""The probe_fusions metric (calls): fuse_buckets calls in set-up's
recorded request, or None where none was recorded."""


def read(ctx):
    n = sum(1 for item in ctx["work"] if item[0] == "fuse_buckets")
    return n or None
''',
}

# What set-up records for each cell of a checkout: a digest of its work,
# the kinds of entry in it, and the probe metric's reading of it.
WORK_OF_CELLS = f"""
import hashlib, json, torch
from portbench import harness
bench, out = harness.benchmark(), {{}}
for w in bench["workloads"]:
    cell = harness.cell(w["name"])
    cell["traffic_params"] = cell["small"]
    flow = harness.flow_class(cell["flow"])(cell, harness.config(cell["config"]), 3, [torch.device("cpu")],
                                            harness.Spans())
    work = []
    flow.warm(work, harness.reported_metrics(bench, w["name"]))
    flow.close()
    probe = harness.metric_reader({METRIC!r})({{"work": work}}) if w["name"] == {CELL!r} else None
    out[w["name"]] = [hashlib.sha256(repr(work).encode()).hexdigest(), sorted({{x[0] for x in work}}), probe]
print(json.dumps(out))
"""


def new_cell_files(with_small: bool) -> dict:
    cfg = harness.config("kitti-odometry")
    cfg.update(name=CONFIG, lengths=[271, 601], reduced=["lengths"])
    cell = {"config": CONFIG, "traffic": MIX, "flow": FLOW, "max_waste": 2.0, "traced_requests": 1,
            "why": "A probe: three short drives longest first, one bucket program",
            "limits": harness.cell("batch-kitti22")["limits"]}
    if with_small:
        cell["small"] = {"kind": KIND, "lengths": [271, 601], "noise_m": 0.02, "variants": 3}
    return {**NEW_FILES, f"configs/{CONFIG}.json": json.dumps(cfg, indent=1),
            f"workloads/{CELL}.json": json.dumps(cell, indent=1)}


def with_new_entries(bench: dict) -> dict:
    bench["configs"].append({"name": CONFIG, "source": "https://www.cvlibs.net/datasets/kitti/eval_odometry.php",
                             "file": f"portbench/configs/{CONFIG}.json", "reduced": ["lengths"],
                             "why": "A probe configuration with a key reduced"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
                               "why": "A probe: three short drives longest first, one bucket program"})
    bench["per_layer"].append({"name": METRIC, "unit": "calls", "better": "lower", "source": "program_counter",
                               "layer": "Batching (parallel.batch, parallel.mesh)", "moves": "poses_per_s",
                               "workloads": [CELL]})
    for m in bench["per_layer"]:
        if m["name"] == "graph_replay_pct":
            m["workloads"].append(CELL)
    return bench


def digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def copy_with_probe(tmp_path, with_small: bool):
    """A copy of the benchmark with the probe added, and the digests of the
    copy's files under ``portbench/`` before the probe went in."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    for p in harness.benchmark()["paths"]:
        shutil.copytree(os.path.join(harness.ROOT, p), os.path.join(root, p),
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    before = digests(os.path.join(root, "portbench"))
    for rel, text in new_cell_files(with_small).items():
        path = os.path.join(root, "portbench", rel)
        assert not os.path.exists(path), rel
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(with_new_entries(harness.benchmark()), f, indent=1)
    return root, before


def run_in(root: str, *args, timeout=900):
    # The copy's benchmark first, the port from this checkout after it.
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, harness.ROOT, os.environ.get("PYTHONPATH", "")])}
    return subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True, text=True, timeout=timeout)


def test_a_cell_added_as_new_files_passes_every_test(tmp_path):
    root, before = copy_with_probe(tmp_path, with_small=True)
    proc = run_in(root, "-m", "pytest", "portbench/tests", "-v", "-p", "no:cacheprovider", "-p", "no:xdist",
                  "-p", "no:randomly", f"--ignore=portbench/tests/{os.path.basename(__file__)}")
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    for test in (f"test_config_found_by_name[{CONFIG}]", f"test_cell_found_by_name[{CELL}]",
                 f"test_metric_found_by_name[{METRIC}]", f"test_small_mixes_cover_every_cell[{CELL}]",
                 f"test_sound_run_is_correct[{CELL}]", f"test_control_fails_a_limit[{CELL}]",
                 f"test_broken_timed_path_is_not_correct[{CELL}-altered_answer]",
                 f"test_broken_timed_path_is_not_correct[{CELL}-half_the_fleet]",
                 f"test_recorded_work_is_what_the_cells_metrics_read[{CELL}]"):
        assert f"{test} PASSED" in proc.stdout, test
    # Set-up records the new metric's calls in the probe cell alone, and
    # its reader reads them; the other cells record what they recorded
    # before the probe went in.
    work = {}
    for where in (root, harness.ROOT):
        proc = run_in(where, "-c", WORK_OF_CELLS)
        assert proc.returncode == 0, proc.stderr[-3000:]
        work[where] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert work[root].pop(CELL)[1:] == [["fuse_buckets"], 1]
    assert work[root] == work[harness.ROOT]
    assert work[root]["batch-kitti22"][1] == ["scan"] and work[root]["refine-kitti00"][1] == []
    after = digests(os.path.join(root, "portbench"))
    assert {k: after.get(k) for k in before} == before, "a file that was there changed"
    assert set(after) - set(before) == set(new_cell_files(True))


def test_a_cell_without_a_small_mix_fails_discovery(tmp_path):
    root, _ = copy_with_probe(tmp_path, with_small=False)
    proc = run_in(root, "-m", "pytest", "portbench/tests/test_portbench_discovery.py", "-q", "-p", "no:cacheprovider",
                  "-p", "no:xdist", "-p", "no:randomly")
    assert proc.returncode != 0
    assert f"FAILED portbench/tests/test_portbench_discovery.py::test_cell_found_by_name[{CELL}]" in proc.stdout
