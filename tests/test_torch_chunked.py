"""The out-of-core building blocks of the port (``utils.streaming``,
``ops.kalman_chunked``, ``ops.alignment_chunked``) against the JAX package,
CPU float64, on the JAX tests' own scenarios and chunk shapes.

Tolerances: chunked EKF + RTS positions ≤1e-10 m and quaternions ≤1e-12
against JAX's ``fuse_ekf_rts_chunked`` (the same element algebra in another
association order); host controls, compaction, window masks and alignment
validity exactly equal; aligned positions ≤1e-10 m; the streamed Sim(3)
(JAX's RANSAC draws injected) R, t and scale ≤1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.config import EKFConfig as JEKFConfig
from gps_optimize_slam_tpu.config import FusionConfig as JFusionConfig
from gps_optimize_slam_tpu.config import RTSDecisionConfig as JRTSDecisionConfig
from gps_optimize_slam_tpu.config import Sim3RansacConfig as JSim3RansacConfig
from gps_optimize_slam_tpu.ops import alignment_chunked as jac
from gps_optimize_slam_tpu.ops import kalman_chunked as jkc
from gps_optimize_slam_tpu_torch.config import FusionConfig, RTSDecisionConfig, Sim3RansacConfig
from gps_optimize_slam_tpu_torch.ops import alignment_chunked, kalman_chunked
from gps_optimize_slam_tpu_torch.utils import streaming
from tests.test_fusion_chunked import _scenario as fusion_scenario
from tests.test_kalman_chunked import _scenario as kalman_scenario
from tests.test_torch_ransac_alignment import jax_sim3_draws


def test_stream_chunks_keeps_the_naive_loop_order():
    log = []
    streaming.stream_chunks(
        range(3),
        lambda i: log.append(("stage", i)) or i,
        lambda i, staged: log.append(("launch", i)) or staged * 10,
        lambda i, out: log.append(("drain", i, out)),
    )
    launches = [e for e in log if e[0] == "launch"]
    drains = [e for e in log if e[0] == "drain"]
    assert launches == [("launch", i) for i in range(3)]
    assert drains == [("drain", i, 10 * i) for i in range(3)]
    # Stage i+1 comes before drain i: the transfer overlaps the compute.
    assert log.index(("stage", 1)) < log.index(("drain", 0, 0))
    calls = []
    streaming.stream_chunks([], calls.append, calls.append, calls.append)
    assert calls == []


def test_controls_numpy_matches_jax():
    t, pos, quat, gps_nan, valid = kalman_scenario(seed=5)
    for mode in ("outage", "full"):
        got = kalman_chunked.controls_numpy(t, quat, gps_nan, valid, RTSDecisionConfig(), mode)
        want = jkc.controls_numpy(t, quat, gps_nan, valid, JRTSDecisionConfig(), mode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rts_mode", ["outage", "full"])
@pytest.mark.parametrize("chunk_size", [48, 159])  # a padded final chunk; one exact chunk
def test_fuse_ekf_rts_chunked_matches_jax(rts_mode, chunk_size):
    t, pos, quat, gps_nan, valid = kalman_scenario()
    want_p, want_q = jkc.fuse_ekf_rts_chunked(
        t, pos, quat, pos[0], quat[0], gps_nan, valid, JEKFConfig(), JRTSDecisionConfig(),
        rts_mode=rts_mode, chunk_size=chunk_size,
    )
    got_p, got_q = kalman_chunked.fuse_ekf_rts_chunked(
        t, pos, quat, pos[0], quat[0], gps_nan, valid, rts_mode=rts_mode,
        chunk_size=chunk_size, device="cpu",
    )
    np.testing.assert_allclose(got_p, want_p, atol=1e-10, rtol=0)
    np.testing.assert_allclose(got_q, want_q, atol=1e-12, rtol=0)


def test_fuse_ekf_rts_chunked_refuses_transition_blending():
    t, pos, quat, gps_nan, valid = kalman_scenario(n=20)
    with pytest.raises(ValueError, match="hard updates"):
        kalman_chunked.fuse_ekf_rts_chunked(
            t, pos, quat, pos[0], quat[0], gps_nan, valid,
            rts_cfg=RTSDecisionConfig(default_ekf_transition_steps_on_sharp_turn=3), device="cpu",
        )


@pytest.mark.parametrize("seed,chunk_size,halo", [(0, 128, 24), (2, None, 64)])
def test_align_gps_to_slam_chunked_matches_jax(seed, chunk_size, halo):
    (st, _, _), (gt, gp, gv) = fusion_scenario(seed=seed)
    chunk = chunk_size or len(st)
    cfg = JFusionConfig().time_alignment
    want_a, want_v = jac.align_gps_to_slam_chunked(st, gt, gp, gps_valid=gv, cfg=cfg,
                                                   chunk_size=chunk, halo=halo)
    got_a, got_v = alignment_chunked.align_gps_to_slam_chunked(
        st, gt, gp, gps_valid=gv, cfg=FusionConfig().time_alignment, chunk_size=chunk,
        halo=halo, device="cpu",
    )
    np.testing.assert_array_equal(got_v, want_v)
    assert 0 < got_v.sum() < len(st)
    np.testing.assert_allclose(got_a[got_v], want_a[want_v], atol=1e-10, rtol=0)
    assert np.isnan(got_a[~got_v]).all()


def test_compact_gps_host_matches_jax():
    (_, _, _), (gt, gp, gv) = fusion_scenario(seed=3)
    perm = np.random.default_rng(0).permutation(len(gt))
    for args in ((gt, gp, gv), (gt[perm], gp[perm], gv[perm])):
        got = alignment_chunked.compact_gps_host(*args, time_offset=0.25, chunk=100)
        want = jac.compact_gps_host(*args, time_offset=0.25, chunk=100)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    dup = gt.copy()
    dup[10:14] = dup[10]  # a run of equal times inside a segment: still deduplicated
    got = alignment_chunked.compact_gps_host(dup, gp, gv)
    np.testing.assert_array_equal(got.ok, jac.compact_gps_host(dup, gp, gv).ok)


@pytest.mark.parametrize("seed", [4, 5])
def test_sim3_window_mask_host_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    t = np.cumsum(rng.uniform(0.05, 0.15, n))
    valid = rng.uniform(size=n) > 0.1
    valid[1000:1100] = False  # a gap > 5 s
    for max_duration, min_samples in ((180.0, 4), (10.0, 4), (180.0, 5000)):
        got = alignment_chunked.sim3_window_mask_host(t, valid, 5.0, max_duration, min_samples)
        want = jac.sim3_window_mask_host(t, valid, 5.0, max_duration, min_samples)
        np.testing.assert_array_equal(got, want)


def test_sim3_ransac_streaming_matches_jax():
    """Above the RANSAC cap the streamed refit (moments over ALL inliers,
    two passes) agrees with JAX's, with JAX's draws on the subsample."""
    rng = np.random.default_rng(5)
    n = 2000
    src = rng.normal(size=(n, 3)) * 30
    R_true = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]])
    dst = 1.3 * src @ R_true.T + np.array([5.0, -2.0, 1.0]) + rng.normal(size=(n, 3)) * 0.01
    dst[::37] += 50.0  # outliers the refit must leave out
    mask = np.ones(n, bool)
    key = jax.random.PRNGKey(0)
    want = jac.sim3_ransac_streaming(key, src, dst, mask, max_ransac_points=256, chunk_size=300)
    n_sub = len(np.flatnonzero(mask)[:: -(-n // 256)])
    draws = jax_sim3_draws(key, np.ones(n_sub, bool), JSim3RansacConfig())
    got = alignment_chunked.sim3_ransac_streaming(
        src, dst, mask, cfg=Sim3RansacConfig(), max_ransac_points=256, chunk_size=300,
        draws=torch.tensor(draws), device="cpu",
    )
    assert got.subsampled and want.subsampled and bool(got.sim3.ok)
    assert got.num_inliers == want.num_inliers == n - len(range(0, n, 37))
    np.testing.assert_allclose(got.sim3.R.numpy(), np.asarray(want.sim3.R), atol=1e-9)
    np.testing.assert_allclose(got.sim3.t.numpy(), np.asarray(want.sim3.t), atol=1e-9)
    assert abs(float(got.sim3.scale) - float(want.sim3.scale)) <= 1e-9


def test_sim3_ransac_streaming_small_window_fails_like_jax():
    src = np.random.default_rng(1).normal(size=(50, 3))
    mask = np.zeros(50, bool)
    mask[:3] = True
    got = alignment_chunked.sim3_ransac_streaming(src, src, mask, device="cpu")
    want = jac.sim3_ransac_streaming(jax.random.PRNGKey(0), src, src, mask)
    assert bool(got.sim3.ok) == bool(want.sim3.ok) is False
    assert (got.num_inliers, got.num_window) == (want.num_inliers, want.num_window) == (0, 3)


def test_filter_step_elements_match_jax_and_the_in_core_elements():
    """The port's chunk-step elements equal the in-core filter's elements
    (prior first), so the chunked scans scan what the in-core path scans."""
    from gps_optimize_slam_tpu_torch.ops import kalman_parallel

    rng = np.random.default_rng(9)
    d, qd, z = (torch.tensor(rng.normal(size=(40, 3))) for _ in range(3))
    qd = qd.abs() + 0.1
    avail = torch.tensor(rng.uniform(size=40) > 0.3)
    R_diag = torch.tensor([0.2, 0.2, 0.2], dtype=torch.float64)
    m0, P0 = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), torch.diag(torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64))
    full = kalman_parallel.filter_elements(m0, P0, d, qd, R_diag, z, avail)
    steps = kalman_parallel.filter_step_elements(avail, d, qd, z, R_diag)
    assert torch.equal(full[:, 1:], steps)
    assert torch.equal(full[:, 0], kalman_parallel.prior_element(m0, torch.diagonal(P0)))
    jsteps = jax.jit(functools.partial(jkc._filter_step_elements, dtype=jnp.float64))(
        jnp.asarray(avail.numpy()), jnp.asarray(d.numpy()), jnp.asarray(qd.numpy()),
        jnp.asarray(z.numpy()), jnp.asarray(R_diag.numpy()),
    )
    packed = np.stack([np.asarray(v) for k in ("A", "b", "C", "eta", "J") for v in jsteps[k]])
    np.testing.assert_allclose(steps.numpy(), packed, rtol=1e-15, atol=0)
