"""No file of the benchmark imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import glob
import os

import pytest

from portbench import harness

FILES = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"), recursive=True))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_anywhere(path):
    found = set(top_level_imports(path)) & {"jax", "jaxlib", "flax", "gps_optimize_slam_tpu"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_port(path):
    assert "gps_optimize_slam_tpu_torch" not in set(top_level_imports(path))


def test_forbidden_names_compared_whole():
    assert harness.forbidden_loaded(["gps_optimize_slam_tpu_torch", "gps_optimize_slam_tpu_torch.ops"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "gps_optimize_slam_tpu.config", "jaxtyping"]) == [
        "gps_optimize_slam_tpu.config", "jax.numpy"]
