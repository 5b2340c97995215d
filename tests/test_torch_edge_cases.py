"""The JAX package's edge-case and fault scenarios (``tests/test_edge_cases.py``
and ``tests/test_faults_robustness.py``) on the port, CPU float64, each with
the JAX test's own inputs and bounds: a fusion without temporal overlap is
not ``ok``; a Sim(3) failure raises RuntimeError and all-invalid GNSS
ValueError; one-row files parse; the southern-hemisphere UTM round trip
holds to 1e-11 degrees with the false northing applied; duplicate SLAM
timestamps give a finite fusion; under combined faults the scale is within
0.05 of 1 and the robust fusion's error has a median below 0.5 m and a
maximum below 3 m; a GNSS bias ramp pulls the fused trajectory more than
1 m off the raw SLAM track by its end while its NN-RMSE stays below 1 m.

The port draws its Sim(3) trials from ``seed`` (JAX from a PRNG key), so
the fusions here are the JAX scenarios under other draws, held to the same
bounds.
"""

import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu_torch import pipeline
from gps_optimize_slam_tpu_torch.config import FusionConfig
from gps_optimize_slam_tpu_torch.io.gps import read_gps_fixes
from gps_optimize_slam_tpu_torch.io.tum import read_tum
from gps_optimize_slam_tpu_torch.models import fusion, robust
from gps_optimize_slam_tpu_torch.ops import geodesy
from gps_optimize_slam_tpu_torch.utils import faults
from tests.test_faults_robustness import build_scene
from tests.test_kalman import make_traj


def tensors(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("case", ["no_overlap", "duplicate_times"])
def test_fuse_core_edge_inputs(case):
    """No temporal overlap (GNSS 1,000 s after the SLAM track): ``ok``
    False and no aligned fix valid. A repeated SLAM timestamp (dt = 0,
    clamped in the filter): ``ok`` and a finite trajectory."""
    t, pos, quats = make_traj(n=50)
    if case == "no_overlap":
        gps_t, gps_p = t + 1000.0, pos.copy()
    else:
        t[30] = t[29]
        gps_t, gps_p = t, pos + 0.01
    out = fusion.fuse_core(*tensors(t, pos, quats, gps_t, gps_p, np.ones(50, bool)), seed=0)
    if case == "no_overlap":
        assert not bool(out.ok)
        assert not out.gps_valid.any()
    else:
        assert bool(out.ok)
        assert torch.isfinite(out.corrected_pos).all()


def test_pipeline_raises_on_sim3_failure(tmp_path):
    """A SLAM file and six GNSS fixes that never overlap it in time: too
    few usable fixes, RuntimeError naming the Sim(3), not garbage."""
    slam = tmp_path / "slam.txt"
    n = 20
    rows = np.column_stack([np.arange(n) * 0.1, np.random.default_rng(0).normal(size=(n, 3)),
                            np.tile([0, 0, 0, 1.0], (n, 1))])
    np.savetxt(slam, rows)
    gps = tmp_path / "gps.txt"
    np.savetxt(gps, np.array([[100.0, 49.0, 8.4, 100.0], [100.5, 49.0001, 8.4001, 100.0],
                              [101.0, 49.0002, 8.4002, 100.0], [101.5, 49.0003, 8.4003, 100.0],
                              [102.0, 49.0004, 8.4004, 100.0], [102.5, 49.0005, 8.4005, 100.0]]))
    with pytest.raises(RuntimeError, match="Sim3"):
        pipeline.fuse_files(str(slam), str(gps), device="cpu")


def test_gps_all_invalid_raises(tmp_path):
    gps = tmp_path / "bad.txt"
    np.savetxt(gps, np.array([[0.0, 0.0, 0.0, 1.0], [1.0, 95.0, 200.0, 1.0]]))
    with pytest.raises(ValueError, match="no valid GPS"):
        pipeline.load_and_project_gps(str(gps), FusionConfig().gps_filtering_ransac, device="cpu")


def test_single_row_files(tmp_path):
    slam = tmp_path / "one.txt"
    slam.write_text("0.0 1 2 3 0 0 0 1\n")
    assert read_tum(str(slam))["positions"].shape == (1, 3)
    g = tmp_path / "one_gps.txt"
    g.write_text("0.0 49.0 8.4 100.0\n")
    r = read_gps_fixes(str(g))
    assert r["valid"].shape == (1,) and r["valid"].all()


def test_southern_hemisphere_roundtrip():
    lons = np.linspace(151.0, 151.3, 50)
    lats = np.linspace(-33.9, -33.7, 50)
    zone, south = geodesy.utm_zone_from_lonlat(lons, lats)
    assert south
    x, y = geodesy.utm_forward(torch.as_tensor(lons), torch.as_tensor(lats), zone, south)
    assert float(y.min()) > 6.2e6  # false northing applied
    lon2, lat2 = geodesy.utm_inverse(x, y, zone, south)
    np.testing.assert_allclose(lon2.numpy(), lons, atol=1e-11)
    np.testing.assert_allclose(lat2.numpy(), lats, atol=1e-11)


def test_pipeline_survives_combined_faults():
    """Noise (0.15 m), 6 % gross outliers of 60 m and three random outages
    on a 400-pose drive: the Sim(3) keeps scale ~1 and the χ²-gated fusion
    stays near the truth."""
    t, pos, quats, gt, gp_true = build_scene()
    gp = faults.inject_noise(gp_true, sigma=0.15, seed=1)
    gp, _ = faults.inject_gross_outliers(gp, fraction=0.06, magnitude=60, seed=2)
    valid = faults.inject_random_outages(np.ones(len(gt), bool), gt, n_outages=3, seed=3)
    cfg = FusionConfig()
    out = fusion.fuse_core(*tensors(t, pos, quats, gt, gp, valid), cfg, seed=0)
    assert bool(out.ok)
    assert abs(float(out.sim3.scale) - 1.0) < 0.05
    res = robust.fuse_robust(torch.as_tensor(t), torch.as_tensor(pos), torch.as_tensor(quats), out.sim3_pos,
                             out.sim3_quat, out.aligned_gps, out.gps_valid, cfg.ekf, cfg.rts_decision)
    err = np.linalg.norm(res.positions.numpy() - pos, axis=1)
    assert np.median(err) < 0.5
    assert err.max() < 3.0


def test_bias_ramp_detected_by_evaluation():
    """A 0.1 m/s east ramp on the GNSS: the fused trajectory follows it
    (more than 1 m off the raw track by its end) and stays consistent with
    it (NN-RMSE below 1 m)."""
    t, pos, quats, gt, gp_true = build_scene(seed=5)
    gp = faults.inject_bias_ramp(gp_true, gt, ramp_per_sec=(0.1, 0.0, 0.0))
    out = fusion.fuse_core(*tensors(t, pos, quats, gt, gp, np.ones(len(gt), bool)), FusionConfig(), seed=0)
    ev = fusion.evaluate(torch.as_tensor(t), torch.as_tensor(pos), out)
    assert float(ev.nn_ekf.rmse) < 1.0
    drift = np.linalg.norm(out.corrected_pos.numpy() - pos, axis=1)
    assert drift[-1] > 1.0
