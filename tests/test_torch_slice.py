"""The port's main path on KITTI seq-04, CPU float64, UTM: ``fuse_core`` +
``evaluate`` against the JAX package and the reference's golden outputs,
``fuse_files`` + ``export_result`` from files against the JAX pipeline, and
the promise that importing the port leaves JAX out.

Tolerances: ≤1e-8 m against the JAX package (JAX's RANSAC draws injected);
≤1e-6 m against ``tests/golden/seq04_golden.npz`` (``corrected_pos`` and the
per-pose ``err_*``), ≤1e-6 relative against ``seq04_meta.json``.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu import pipeline as jpipeline
from gps_optimize_slam_tpu.config import FusionConfig as JFusionConfig
from gps_optimize_slam_tpu.models import fusion as jfusion
from gps_optimize_slam_tpu.ops import alignment as jal
from gps_optimize_slam_tpu_torch import pipeline
from gps_optimize_slam_tpu_torch.config import FusionConfig, config_from_dict
from gps_optimize_slam_tpu_torch.models import fusion
from gps_optimize_slam_tpu_torch.ops import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "seq04_golden.npz")
META = os.path.join(HERE, "golden", "seq04_meta.json")
STATS = ("mean", "median", "rmse", "max", "count")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def jax_run(golden):
    """JAX fuse_core + evaluate on the golden arrays, and its Sim3 draws."""
    cfg = JFusionConfig(gps_sorted=True, platform="cpu")
    key = jax.random.PRNGKey(0)
    st, sp, sq = (jnp.asarray(golden[k]) for k in ("slam_times", "slam_pos", "slam_quat"))
    gt, gp = jnp.asarray(golden["gps_times"]), jnp.asarray(golden["gps_utm"])
    gv = jnp.ones(gt.shape, bool)
    out = jfusion.fuse_core(st, sp, sq, gt, gp, gv, key, cfg)
    ev = jfusion.evaluate(st, sp, out, platform="cpu")
    aligned = jax.jit(functools.partial(jal.align_gps_to_slam, assume_sorted=True, platform="cpu"))(st, gt, gp, gv)
    window = jal.sim3_window_mask(st, aligned.valid, 5.0, 180.0, 4)
    keys = jax.random.split(key, cfg.sim3_ransac.max_trials)
    hi = jnp.maximum(jnp.sum(window), 1)
    draws = jax.vmap(lambda k: jax.random.randint(k, (4,), 0, hi))(keys)
    return cfg, out, ev, np.asarray(draws)


def port_inputs(golden):
    return [torch.tensor(golden[k]) for k in ("slam_times", "slam_pos", "slam_quat", "gps_times", "gps_utm")]


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_fuse_core_and_evaluate_match_jax(golden, jax_run, platform):
    """platform="cpu" takes the sequential filter, "gpu" the parallel scans
    (on CPU tensors, through the plain K1 ladder)."""
    jcfg, jout, jev, draws = jax_run
    cfg = config_from_dict(dataclasses.asdict(jcfg)).replace(platform=platform)
    st, sp, sq, gt, gp = port_inputs(golden)
    out = fusion.fuse_core(st, sp, sq, gt, gp, torch.ones(len(gt), dtype=torch.bool), cfg,
                           sim3_draws=torch.tensor(draws))
    assert bool(out.ok) and bool(jout.ok)
    np.testing.assert_array_equal(out.sim3_inliers.numpy(), np.asarray(jout.sim3_inliers))
    np.testing.assert_array_equal(out.gps_valid.numpy(), np.asarray(jout.gps_valid))
    for name in ("corrected_pos", "sim3_pos", "aligned_gps"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-8, rtol=0, err_msg=name)
    np.testing.assert_allclose(out.corrected_quat.numpy(), np.asarray(jout.corrected_quat), atol=1e-10)
    np.testing.assert_allclose(out.sim3.R.numpy(), np.asarray(jout.sim3.R), atol=1e-10)
    assert abs(float(out.sim3.scale) - float(jout.sim3.scale)) <= 1e-10
    ev = fusion.evaluate(st, sp, out)
    for part in ("nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf"):
        for stat in STATS:
            got, want = float(getattr(getattr(ev, part), stat)), float(getattr(getattr(jev, part), stat))
            assert abs(got - want) <= 1e-8, (part, stat, got, want)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_fuse_arrays_reproduces_golden(golden, platform):
    meta = json.load(open(META))
    slam = {"timestamps": golden["slam_times"], "positions": golden["slam_pos"],
            "quaternions": golden["slam_quat"]}
    gps = pipeline.GPSData(timestamps=golden["gps_times"], positions=golden["gps_utm"],
                           valid=np.ones(279, bool), frame="utm", utm_zone=32, utm_south=False)
    res = pipeline.fuse_arrays(slam, gps, config=FusionConfig(platform=platform), device="cpu")
    assert np.abs(res.corrected_pos - golden["corrected_pos"]).max() <= 1e-6
    dots = np.abs(np.sum(res.corrected_quat * golden["corrected_quat"], axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-9)
    assert int(res.outputs.sim3_inliers.sum()) == len(golden["sim3_calc_idx"])
    out = res.outputs
    gate = metrics.eval_mask(torch.tensor(golden["slam_times"]), out.gps_valid, 5.0)
    np.testing.assert_array_equal(np.where(gate.numpy())[0], golden["eval_post5s_idx"])
    cands = torch.nan_to_num(out.aligned_gps, nan=0.0)
    for name, traj in (("slam", torch.tensor(golden["slam_pos"])), ("sim3", out.sim3_pos),
                       ("ekf", out.corrected_pos)):
        err = metrics.nn_errors_auto(traj, cands, gate, gate).numpy()[gate.numpy()]
        np.testing.assert_allclose(err, golden[f"err_{name}"], atol=1e-6, rtol=0, err_msg=name)
    ev = res.evaluation
    for got, key in ((res.sim3_scale, "sim3_scale"), (float(ev.nn_sim3.rmse), "rmse_sim3"),
                     (float(ev.nn_ekf.rmse), "rmse_ekf"), (float(ev.nn_ekf.mean), "mean_ekf")):
        assert abs(got / meta[key] - 1) <= 1e-6, key
    assert "scale=0.986986" in res.summary()


def test_fuse_files_and_export_match_jax_pipeline(tmp_path):
    slam_path, gps_path = chip_smoke.write_seq04_files(str(tmp_path))
    res = pipeline.fuse_files(slam_path, gps_path, frame="utm", device="cpu")
    jres = jpipeline.fuse_files(slam_path, gps_path, frame="utm")
    assert res.gps.valid.all() and jres.gps.valid.all() and res.gps.valid.shape == (279,)
    assert (res.gps.utm_zone, res.gps.utm_south) == (jres.gps.utm_zone, jres.gps.utm_south)
    np.testing.assert_allclose(res.gps.positions, jres.gps.positions, atol=1e-8, rtol=0)
    np.testing.assert_allclose(res.corrected_pos, jres.corrected_pos, atol=1e-8, rtol=0)
    assert abs(res.sim3_scale - jres.sim3_scale) <= 1e-10
    paths = {}
    for name, mod, r in (("port", pipeline, res), ("jax", jpipeline, jres)):
        paths[name] = (str(tmp_path / f"{name}_utm.txt"), str(tmp_path / f"{name}_wgs84.txt"))
        mod.export_result(r, *paths[name])
    for i in range(2):
        got, want = np.loadtxt(paths["port"][i]), np.loadtxt(paths["jax"][i])
        assert got.shape == want.shape == (271, 8)
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_failed_alignment_raises(golden):
    slam = {"timestamps": golden["slam_times"], "positions": golden["slam_pos"],
            "quaternions": golden["slam_quat"]}
    valid = np.zeros(279, bool)
    valid[:3] = True  # three fixes: no Sim3 window
    gps = pipeline.GPSData(timestamps=golden["gps_times"], positions=golden["gps_utm"],
                           valid=valid, frame="utm", utm_zone=32, utm_south=False)
    with pytest.raises(RuntimeError, match="Sim3 global alignment failed"):
        pipeline.fuse_arrays(slam, gps, device="cpu")


def test_importing_the_port_leaves_jax_out():
    modules = [
        "gps_optimize_slam_tpu_torch.pipeline",
        "gps_optimize_slam_tpu_torch.models.fusion",
        "gps_optimize_slam_tpu_torch.models.fusion_chunked",
        "gps_optimize_slam_tpu_torch.models.robust",
        "gps_optimize_slam_tpu_torch.cli",
        "gps_optimize_slam_tpu_torch.utils.faults",
        "gps_optimize_slam_tpu_torch.utils.logging",
        "gps_optimize_slam_tpu_torch.ops.kalman_chunked",
        "gps_optimize_slam_tpu_torch.ops.alignment_chunked",
        "gps_optimize_slam_tpu_torch.utils.streaming",
        "gps_optimize_slam_tpu_torch.utils.device",
        "gps_optimize_slam_tpu_torch.ops._build",
        "gps_optimize_slam_tpu_torch.ops.kernels",
        "gps_optimize_slam_tpu_torch.ops.scan",
        "gps_optimize_slam_tpu_torch.ops.kalman_parallel",
        "gps_optimize_slam_tpu_torch.io.native",
        "chip_smoke",
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'gps_optimize_slam_tpu.')) or m == 'gps_optimize_slam_tpu')\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(HERE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stderr
