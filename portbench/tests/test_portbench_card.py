"""On a card: each cell runs as the driver runs it and comes out correct.
Skipped without the cards a cell needs (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    chips = harness.config(harness.cell(cell)["config"])["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(2**31 + 77),
                           "--seconds", "3", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ})
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
