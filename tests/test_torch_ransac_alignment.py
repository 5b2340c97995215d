"""RANSAC, temporal alignment and the tridiagonal solver of the port against
the JAX package, CPU float64.

Random draws cannot be shared between jax's threefry and torch, so the
tests reproduce the JAX package's key splits here (``ransac.py`` lines 177,
423, 482 and 490) and hand the resulting draws to the port.

Tolerances: masks and validity exactly equal; R, t, s ≤1e-10; aligned
positions ≤1e-9 m; tridiagonal solutions ≤1e-10 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gps_optimize_slam_tpu.config import GPSFilterConfig as JGPSFilterConfig
from gps_optimize_slam_tpu.config import Sim3RansacConfig as JSim3RansacConfig
from gps_optimize_slam_tpu.config import TimeAlignConfig as JTimeAlignConfig
from gps_optimize_slam_tpu.ops import alignment as jal
from gps_optimize_slam_tpu.ops import ransac as jr
from gps_optimize_slam_tpu.ops import tridiag as jtd
from gps_optimize_slam_tpu_torch.config import GPSFilterConfig, Sim3RansacConfig, TimeAlignConfig
from gps_optimize_slam_tpu_torch.ops import alignment, ransac, tridiag


def jax_sim3_draws(key, valid, cfg):
    keys = jax.random.split(key, cfg.max_trials)
    hi = jnp.maximum(jnp.sum(jnp.asarray(valid)), 1)
    return np.asarray(jax.vmap(lambda k: jax.random.randint(k, (cfg.min_samples,), 0, hi))(keys))


def sim3_problem(seed, n=160, outliers=0.25):
    rng = np.random.default_rng(seed)
    src = np.cumsum(rng.normal(size=(n, 3)) * 2.0, axis=0)
    src[:, 2] *= 0.05  # a nearly planar drive, like KITTI
    ang = rng.normal() * 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0.0], [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    dst = 0.987 * src @ R.T + np.array([455_000.0, 5_431_000.0, 112.0])
    dst += rng.normal(size=(n, 3)) * 0.3
    bad = rng.uniform(size=n) < outliers
    dst[bad] += rng.normal(size=(bad.sum(), 3)) * 30.0
    valid = rng.uniform(size=n) > 0.1
    return src, dst, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim3_ransac_matches_jax_with_injected_draws(seed):
    src, dst, valid = sim3_problem(seed)
    jcfg = JSim3RansacConfig(max_trials=200)
    key = jax.random.PRNGKey(seed)
    fit = jax.jit(functools.partial(jr.sim3_ransac, cfg=jcfg, platform="cpu"))
    want = fit(key, jnp.asarray(src), jnp.asarray(dst), valid=jnp.asarray(valid))
    draws = jax_sim3_draws(key, valid, jcfg)
    got = ransac.sim3_ransac(torch.tensor(src), torch.tensor(dst), torch.tensor(valid),
                             cfg=Sim3RansacConfig(max_trials=200), draws=torch.tensor(draws))
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert int(got.num_inliers) == int(want.num_inliers)
    assert bool(got.ok) == bool(want.ok) is True
    np.testing.assert_allclose(got.sim3.R.numpy(), np.asarray(want.sim3.R), atol=1e-10)
    # t sits at UTM magnitude (~5e6 m): 1e-10 relative.
    np.testing.assert_allclose(got.sim3.t.numpy(), np.asarray(want.sim3.t), rtol=1e-10)
    assert abs(float(got.sim3.scale) - float(want.sim3.scale)) <= 1e-10


def test_sim3_ransac_is_seed_independent_on_clean_data():
    src, dst, valid = sim3_problem(4, outliers=0.0)
    cfg = Sim3RansacConfig()
    a = ransac.sim3_ransac(torch.tensor(src), torch.tensor(dst), torch.tensor(valid), cfg=cfg, seed=0)
    b = ransac.sim3_ransac(torch.tensor(src), torch.tensor(dst), torch.tensor(valid), cfg=cfg, seed=7)
    assert torch.equal(a.inlier_mask, b.inlier_mask)
    torch.testing.assert_close(a.sim3.R, b.sim3.R, rtol=0, atol=1e-12)


def test_sim3_ransac_too_few_points_fails_like_jax():
    src, dst, valid = sim3_problem(5, n=10)
    valid[:] = False
    valid[:3] = True
    got = ransac.sim3_ransac(torch.tensor(src), torch.tensor(dst), torch.tensor(valid))
    fit = jax.jit(functools.partial(jr.sim3_ransac, cfg=JSim3RansacConfig(max_trials=200), platform="cpu"))
    want = fit(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(dst), valid=jnp.asarray(valid))
    assert bool(got.ok) == bool(want.ok) is False
    assert not got.inlier_mask.any()


def gnss_track(seed, n=300):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1 + rng.uniform(0, 0.01, n)
    pos = np.stack([3.0 * t + 0.05 * t**2, 1.5 * t, 0.01 * t], 1) + rng.normal(size=(n, 3)) * 0.3
    spikes = rng.choice(n, 12, replace=False)
    pos[spikes] += rng.normal(size=(12, 3)) * 60.0
    valid = rng.uniform(size=n) > 0.05
    return t, pos, valid


def jax_gate_draws(key, times, valid, window_starts, cfg):
    """The subset indices JAX draws: window keys → 3 axis keys → trial keys
    → Gumbel top-k over the window's members."""
    m = times.shape[0]
    use_windows = cfg.use_sliding_window and window_starts is not None
    starts = jnp.asarray(window_starts) if use_windows else jnp.zeros((1,))

    def per_window(wk, start):
        if use_windows:
            in_window = (times >= start) & (times < start + cfg.window_duration_seconds) & valid
        else:
            in_window = jnp.asarray(valid)
        ks = jax.random.split(wk, 3)

        def per_axis(k):
            keys = jax.random.split(k, cfg.max_trials)
            return jax.vmap(lambda tk: jr._sample_without_replacement(tk, in_window, cfg.min_samples))(keys)

        return jax.vmap(per_axis)(ks)

    wkeys = jax.random.split(key, starts.shape[0])
    assert m == valid.shape[0]
    return np.asarray(jax.vmap(per_window)(wkeys, starts))


@pytest.mark.parametrize("sliding", [True, False])
def test_gps_gate_matches_jax_with_injected_draws(sliding):
    t, pos, valid = gnss_track(10)
    cfg = GPSFilterConfig(use_sliding_window=sliding)
    jcfg = JGPSFilterConfig(use_sliding_window=sliding)
    starts = None
    if sliding:
        starts = jr.reference_window_starts(t[valid], jcfg)
        np.testing.assert_array_equal(ransac.reference_window_starts(t[valid], cfg), starts)
    key = jax.random.PRNGKey(3)
    gate = jax.jit(functools.partial(jr.gps_poly_ransac_mask, cfg=jcfg))
    want = np.asarray(gate(key, jnp.asarray(t), jnp.asarray(pos), valid=jnp.asarray(valid),
                           window_starts=None if starts is None else jnp.asarray(starts)))
    draws = jax_gate_draws(key, jnp.asarray(t), jnp.asarray(valid), starts, jcfg)
    got = ransac.gps_poly_ransac_mask(
        torch.tensor(t), torch.tensor(pos), valid=torch.tensor(valid),
        window_starts=None if starts is None else torch.tensor(starts),
        cfg=cfg, draws=torch.tensor(draws),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (valid & ~got).sum() <= 20  # the spikes go, the track stays


def test_gps_gate_disabled_passes_valid_through():
    t, pos, valid = gnss_track(11, n=50)
    got = ransac.gps_poly_ransac_mask(torch.tensor(t), torch.tensor(pos), torch.tensor(valid),
                                      cfg=GPSFilterConfig(enabled=False))
    np.testing.assert_array_equal(got.numpy(), valid)


def alignment_case(seed, m):
    rng = np.random.default_rng(seed)
    gt = np.sort(rng.uniform(0.0, 0.1 * m, m))
    gt[m // 2 :] += 8.0  # a GNSS gap > 5 s splits the segments
    gt[10] = gt[9]  # a duplicate timestamp
    gp = np.stack([np.sin(gt / 7) * 40, np.cos(gt / 5) * 30, gt * 0.01], 1) + rng.normal(size=(m, 3)) * 0.1
    gv = rng.uniform(size=m) > 0.05
    gv[m - 3 :] = [True, False, True]  # a 2-point tail segment after the gap below
    gt[m - 3 :] += 9.0
    st = np.linspace(gt[0] - 1.0, gt[-1] + 1.0, 2 * m)
    return st, gt, gp, gv


@pytest.mark.parametrize("solver,m", [("dense", 90), ("tridiagonal", 300), ("auto", 300)])
@pytest.mark.parametrize("assume_sorted", [False, True])
def test_align_gps_to_slam_matches_jax(solver, m, assume_sorted):
    st, gt, gp, gv = alignment_case(m, m)
    align = jax.jit(functools.partial(
        jal.align_gps_to_slam, cfg=JTimeAlignConfig(), spline_solver=solver,
        assume_sorted=assume_sorted, platform="cpu",
    ))
    want = align(jnp.asarray(st), jnp.asarray(gt), jnp.asarray(gp), gps_valid=jnp.asarray(gv))
    got = alignment.align_gps_to_slam(
        torch.tensor(st), torch.tensor(gt), torch.tensor(gp), gps_valid=torch.tensor(gv),
        cfg=TimeAlignConfig(), spline_solver=solver, assume_sorted=assume_sorted,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < len(st)
    np.testing.assert_allclose(got.aligned.numpy(), np.asarray(want.aligned), atol=1e-9, rtol=0)


def test_align_unsorted_input_with_offset_matches_jax():
    st, gt, gp, gv = alignment_case(5, 120)
    perm = np.random.default_rng(0).permutation(len(gt))
    args = (gt[perm], gp[perm], gv[perm])
    align = jax.jit(functools.partial(jal.align_gps_to_slam, time_offset=0.25, platform="cpu"))
    want = align(jnp.asarray(st), *(jnp.asarray(a) for a in args))
    got = alignment.align_gps_to_slam(torch.tensor(st), *(torch.tensor(a) for a in args), time_offset=0.25)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.aligned.numpy(), np.asarray(want.aligned), atol=1e-9, rtol=0)


@pytest.mark.parametrize("m,n_valid,solver", [(2, 2, "dense"), (4, 4, "tridiagonal"), (6, 1, "dense"), (5, 0, "dense")])
def test_align_tiny_gnss_tracks_match_jax(m, n_valid, solver):
    """Two points interpolate linearly, four make a cubic, one or none
    cover nothing."""
    rng = np.random.default_rng(m)
    st = np.linspace(0.0, 10.0, 50)
    gt, gp = np.sort(rng.uniform(0, 10, m)), rng.normal(size=(m, 3))
    gv = np.arange(m) < n_valid
    align = jax.jit(functools.partial(jal.align_gps_to_slam, spline_solver=solver, platform="cpu"))
    want = align(jnp.asarray(st), jnp.asarray(gt), jnp.asarray(gp), gps_valid=jnp.asarray(gv))
    got = alignment.align_gps_to_slam(torch.tensor(st), torch.tensor(gt), torch.tensor(gp),
                                      gps_valid=torch.tensor(gv), spline_solver=solver)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.aligned.numpy(), np.asarray(want.aligned), atol=1e-9, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sim3_window_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 400
    t = np.cumsum(rng.uniform(0.05, 0.15, n))
    valid = rng.uniform(size=n) > 0.1
    valid[rng.integers(0, n, 3)] = False
    if seed % 2:
        valid[100:160] = False  # a gap > 5 s inside the window
    window = jax.jit(jal.sim3_window_mask, static_argnums=(2, 3, 4))
    for max_duration in (180.0, 10.0):
        want = window(jnp.asarray(t), jnp.asarray(valid), 5.0, max_duration, 4)
        got = alignment.sim3_window_mask(torch.tensor(t), torch.tensor(valid), 5.0, max_duration, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_estimate_time_offset_is_the_reference_computation():
    rng = np.random.default_rng(1)
    a, b = np.sort(rng.uniform(0, 30, 271)), np.sort(rng.uniform(0, 30, 279))
    assert alignment.estimate_time_offset(a, b) == jal.estimate_time_offset(a, b) == 0.0


def test_tridiag_solve_matches_jax():
    rng = np.random.default_rng(2)
    n = 500
    a, c = rng.uniform(0.05, 0.2, n), rng.uniform(0.05, 0.2, n)
    b = rng.uniform(0.6, 1.0, n)
    reset = rng.uniform(size=n) < 0.1  # identity rows decouple segments
    a[reset], c[reset], b[reset] = 0.0, 0.0, 1.0
    d = rng.normal(size=(n, 3))
    solve = jax.jit(functools.partial(jtd.tridiag_solve, platform="cpu"))
    want = np.asarray(solve(*(jnp.asarray(x) for x in (a, b, c, d))))
    got = tridiag.tridiag_solve(*(torch.tensor(x) for x in (a, b, c, d))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    A = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    np.testing.assert_allclose(A @ got, d, atol=1e-10)
