"""The port's EKF/RTS fusion against the JAX package, CPU float64: the
sequential filter (the CPU path, and the only one with transition blending)
and the parallel scans (the accelerator path, through K1), with GNSS
outages, a sharp turn inside an outage, and both RTS modes.

Tolerance: ≤1e-8 m on positions, ≤1e-10 on quaternion components; the
control signals exactly equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.config import EKFConfig as JEKFConfig
from gps_optimize_slam_tpu.config import RTSDecisionConfig as JRTSDecisionConfig
from gps_optimize_slam_tpu.ops import kalman as jk
from gps_optimize_slam_tpu.ops import kalman_parallel as jkp
from gps_optimize_slam_tpu_torch.config import EKFConfig, RTSDecisionConfig
from gps_optimize_slam_tpu_torch.ops import kalman, kalman_parallel


def scenario(seed, n=220):
    """A drive with three GNSS outages; the second holds a sharp turn, and
    the trajectory ends inside an outage (no recovery, no RTS)."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.09, 0.11, n))
    yaw = np.cumsum(rng.normal(size=n) * 0.01)
    yaw[95:100] += np.linspace(0, 1.2, 5)  # ~2.4 rad/s: sharp
    yaw[100:] += 1.2
    q = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2), np.cos(yaw / 2)], 1)
    q[150] = 0.0  # a degenerate quaternion inside an outage
    step = np.stack([np.cos(yaw), np.sin(yaw), 0.01 * rng.normal(size=n)], 1)
    pos = np.cumsum(step, 0)
    ang = 0.4
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    sim3_pos = 0.98 * pos @ Rz.T + np.array([10.0, -5.0, 2.0])
    qR = np.array([0.0, 0.0, np.sin(ang / 2), np.cos(ang / 2)])
    x1, y1, z1, w1 = qR
    x2, y2, z2, w2 = q.T
    sim3_quat = np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], 1)
    gps = sim3_pos + rng.normal(size=(n, 3)) * 0.3 + 0.5
    valid = np.ones(n, bool)
    valid[0] = False
    valid[40:55] = False
    valid[92:104] = False
    valid[140:160] = False
    valid[200:] = False
    gps[~valid] = np.nan
    valid[141] = True  # flagged valid but NaN: the filter must skip it
    return times, pos, q, sim3_pos, sim3_quat, gps, valid


def as_torch(arrs):
    return [torch.tensor(a) for a in arrs]


def as_jax(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("steps", [0, 3])
def test_controls_match_jax(steps):
    times, _, q, _, _, gps, valid = scenario(0)
    rts = RTSDecisionConfig(default_ekf_transition_steps_on_sharp_turn=steps)
    jrts = JRTSDecisionConfig(default_ekf_transition_steps_on_sharp_turn=steps)
    got = kalman.precompute_controls(*as_torch((times, q, gps, valid)), rts)
    want = jax.jit(functools.partial(jk.precompute_controls, rts_cfg=jrts))(*as_jax((times, q, gps, valid)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.sharp_turn.any() and got.rts_member.any()


def _check(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-8, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-10, rtol=0)


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
@pytest.mark.parametrize("steps", [0, 3])
def test_sequential_fusion_matches_jax(rts_mode, steps):
    args = scenario(1)
    ekf = EKFConfig()
    rts = RTSDecisionConfig(default_ekf_transition_steps_on_sharp_turn=steps)
    jrts = JRTSDecisionConfig(default_ekf_transition_steps_on_sharp_turn=steps)
    got = kalman.fuse_ekf_rts(*as_torch(args), ekf, rts, rts_mode=rts_mode)
    fuse = jax.jit(functools.partial(jk.fuse_ekf_rts, ekf_cfg=JEKFConfig(), rts_cfg=jrts, rts_mode=rts_mode))
    _check(got, fuse(*as_jax(args)))


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
def test_parallel_fusion_matches_jax(rts_mode):
    args = scenario(2)
    got = kalman_parallel.fuse_ekf_rts_parallel(*as_torch(args), EKFConfig(), RTSDecisionConfig(),
                                                rts_mode=rts_mode)
    fuse = jax.jit(functools.partial(
        jkp.fuse_ekf_rts_parallel, ekf_cfg=JEKFConfig(), rts_cfg=JRTSDecisionConfig(),
        rts_mode=rts_mode, platform="cpu",
    ))
    _check(got, fuse(*as_jax(args)))
    # The two port paths agree with each other as well.
    seq = kalman.fuse_ekf_rts(*as_torch(args), EKFConfig(), RTSDecisionConfig(), rts_mode=rts_mode)
    np.testing.assert_allclose(got[0].numpy(), seq[0].numpy(), atol=1e-8, rtol=0)


def test_parallel_fusion_refuses_blending():
    with pytest.raises(ValueError):
        kalman_parallel.fuse_ekf_rts_parallel(
            *as_torch(scenario(3, n=20)), EKFConfig(),
            RTSDecisionConfig(default_ekf_transition_steps_on_sharp_turn=2),
        )
