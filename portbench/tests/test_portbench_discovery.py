"""Everything the benchmark runs is found by name, and BENCHMARK.json keeps
to the benchmark's contract."""

import importlib
import json
import os
import re

import pytest

from portbench import harness
from portbench.traffic import generate

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_has_exactly_the_contract_keys():
    assert sorted(BENCH) == sorted(["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"])
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # 24 cells' full check fits the driver's 43,200 seconds.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    assert sorted(cfg) == ["file", "name", "reduced", "source", "why"]
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    on_disk = harness.config(cfg["name"])
    assert on_disk["name"] == cfg["name"] and on_disk["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    assert all(isinstance(k, str) and len(k) <= 200 and NAME.match(k) for k in cfg["reduced"])
    assert on_disk["chips"] in (1, 4) and on_disk["dtype"] in ("float32", "float64")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    assert 1 <= len(cfg["source"]) <= 200 and 1 <= len(cfg["why"]) <= 200


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(wl):
    assert sorted(wl) == ["chips", "config", "name", "traffic", "why"]
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"]) and len(wl["why"]) <= 200
    cell = harness.cell(wl["name"])
    assert cell["config"] == wl["config"] and cell["traffic"] == wl["traffic"] and cell["why"] == wl["why"]
    assert harness.config(wl["config"])["chips"] == wl["chips"]
    kind = generate.kind_module(generate.load(wl["traffic"])["kind"])
    assert callable(kind.drives)
    assert cell["small"]["kind"] == generate.load(wl["traffic"])["kind"], "the CPU tests' small mix"
    flow = harness.flow_class(cell["flow"])
    assert callable(flow.request) and callable(flow.check) and callable(flow.control)
    assert cell["limits"], "every cell compares its outputs with the reference"
    # Every cell reports setup_s, another end-to-end metric and a per-layer one.
    e2e = harness.cell_metrics(BENCH, wl["name"], False)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, wl["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_found_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    meta = harness.load_json("metrics", m["name"], "metric.json")
    assert meta["unit"] == m["unit"] and meta["better"] == m["better"] and meta["source"] == m["source"]
    assert callable(harness.metric_reader(m["name"]))
    assert "cells" not in meta, "BENCHMARK.json alone lists a metric's cells"
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    assert set(cells) <= {w["name"] for w in BENCH["workloads"]}
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert meta["layer"] == m["layer"] and meta["moves"] == m["moves"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for c in cells:  # each cell of a per-layer metric reports what it moves
            assert "workloads" not in moved or c in moved["workloads"]


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_flows_found_by_name():
    for wl in BENCH["workloads"]:
        flow = harness.cell(wl["name"])["flow"]
        importlib.import_module(f"portbench.flows.{flow}")
        faults = importlib.import_module(f"portbench.tests.faults.{flow}").FAULTS
        assert "altered_answer" in [f.__name__ for f in faults], f"faults/{flow}.py alters no answer"
    assert os.path.isfile(generate.GOLDEN)


def test_records_name_program_calls():
    records = harness.declared_records(sorted(os.listdir(os.path.join(harness.HERE, "metrics"))))
    for module, name, note in records:
        assert callable(getattr(importlib.import_module(module), name)) and callable(note)
    assert ("gps_optimize_slam_tpu_torch.ops.scan", "scan_block") in {r[:2] for r in records}
    assert harness.declared_records(["poses_per_s"]) == [], "a metric without records.py records nothing"


def test_unknown_kind_of_mix_is_refused():
    for kind in ("no_such_kind", "../generate", "generate.x", ""):
        with pytest.raises(ValueError):
            generate.kind_module(kind)
