"""The PyTorch port's config and file I/O against the JAX package.

Tolerance: exact. The dataclasses must carry the same fields and defaults,
a JAX config must round-trip through the port's ``config_from_dict``, and
the readers must return the same arrays for the same files.
"""

import dataclasses

import numpy as np
import pytest

from gps_optimize_slam_tpu import config as jcfg
from gps_optimize_slam_tpu.io import gps as jgps
from gps_optimize_slam_tpu.io import native as jnative
from gps_optimize_slam_tpu.io import tum as jtum
from gps_optimize_slam_tpu_torch import config as tcfg
from gps_optimize_slam_tpu_torch.io import gps as tgps
from gps_optimize_slam_tpu_torch.io import native as tnative
from gps_optimize_slam_tpu_torch.io import tum as ttum

CLASSES = [
    "EKFConfig",
    "Sim3RansacConfig",
    "GPSFilterConfig",
    "TimeAlignConfig",
    "RTSDecisionConfig",
    "FusionConfig",
]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, name))}
    assert list(jf) == list(tf)
    for key in jf:
        assert tf[key].type == jf[key].type, key
        jd, td = jf[key].default, tf[key].default
        if dataclasses.is_dataclass(jd):
            assert dataclasses.asdict(td) == dataclasses.asdict(jd), key
        else:
            assert td == jd, key


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        {"ekf_scan": "sequential", "rts_mode": "full", "platform": "gpu", "gps_sorted": True},
        {
            "ekf": jcfg.EKFConfig(meas_noise_diag=(0.3, 0.3, 0.5), transition_steps=4),
            "sim3_ransac": jcfg.Sim3RansacConfig(max_trials=64, residual_threshold=2.5),
            "gps_filtering_ransac": jcfg.GPSFilterConfig(window_duration_seconds=9.0),
            "rts_decision": jcfg.RTSDecisionConfig(default_ekf_transition_steps_on_sharp_turn=3),
        },
    ],
)
def test_config_from_dict_rebuilds_jax_config(overrides):
    jax_cfg = jcfg.FusionConfig(**overrides)
    port_cfg = tcfg.config_from_dict(dataclasses.asdict(jax_cfg))
    assert isinstance(port_cfg, tcfg.FusionConfig)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert port_cfg == tcfg.config_from_dict(dataclasses.asdict(port_cfg))


def test_config_from_dict_rejects_unknown_keys():
    with pytest.raises(ValueError):
        tcfg.config_from_dict({"nope": 1})


def _random_tum(rng, n):
    ts = np.cumsum(rng.uniform(0.05, 0.15, n))
    pos = rng.normal(size=(n, 3)) * 100
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = 0.0  # a zero-norm quaternion survives the round trip
    return ts, pos, q


@pytest.mark.parametrize("native", [True, False])
def test_tum_roundtrip_matches_jax(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(tnative, "_get_lib", lambda: None)
    rng = np.random.default_rng(0)
    ts, pos, q = _random_tum(rng, 57)
    path = str(tmp_path / "traj.tum")
    ttum.write_tum(path, ts, pos, q)
    got, want = ttum.read_tum(path), jtum.read_tum(path)
    for key in ("timestamps", "positions", "quaternions"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["positions"], pos, atol=1e-6)

    path_j = str(tmp_path / "traj_jax.tum")
    jtum.write_tum(path_j, ts, pos, q)
    assert open(path_j).read() == open(path).read()


@pytest.mark.parametrize("lon_first", [False, True])
@pytest.mark.parametrize("delimiter", [" ", ","])
def test_gnss_read_matches_jax(tmp_path, lon_first, delimiter):
    rng = np.random.default_rng(1)
    n = 40
    lat = 49.0 + rng.normal(size=n) * 1e-3
    lon = 8.4 + rng.normal(size=n) * 1e-3
    lat[3], lon[7], lat[11] = 0.0, 200.0, -95.0  # range/zero gating (Q12)
    cols = [lon, lat] if lon_first else [lat, lon]
    rows = np.column_stack([np.arange(n) * 0.1, *cols, 110 + rng.normal(size=n), np.ones(n)])
    path = str(tmp_path / "gnss.txt")
    np.savetxt(path, rows, fmt="%.10f", delimiter=delimiter)
    got = tgps.read_gps_fixes(path, lon_first=lon_first)
    want = jgps.read_gps_fixes(path, lon_first=lon_first)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert int(got["valid"].sum()) == n - 3


def test_missing_files_raise_like_jax(tmp_path):
    missing = str(tmp_path / "nope.txt")
    for reader in (ttum.read_tum, tgps.read_gps_fixes):
        with pytest.raises(ValueError, match="not found"):
            reader(missing)


def test_native_available_matches_jax(monkeypatch):
    """Both packages find the same native parser, and the port's answer
    follows its loader."""
    assert tnative.native_available() == jnative.native_available()
    monkeypatch.setattr(tnative, "_get_lib", lambda: None)
    assert tnative.native_available() is False
