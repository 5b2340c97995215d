"""RANSAC, temporal alignment and the tridiagonal solver of the port against
the JAX package, CPU float64.

Random draws cannot be shared between jax's threefry and torch, so the
tests reproduce the JAX package's key splits here (``ransac.py`` lines 177,
423, 482 and 490, and 195 and 436 under ``stop_probability``, which split
the whole chunk schedule's keys) and hand the resulting draws to the port.
The number of chunks JAX's adaptive loop ran is read by wrapping
``jax.lax.while_loop`` with a counter.

Tolerances: masks and validity exactly equal; R, t, s ≤1e-10; aligned
positions ≤1e-9 m; tridiagonal solutions ≤1e-10 relative; window starts of
the device form equal to the host form's.
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
from gps_optimize_slam_tpu_torch.ops import alignment, alignment_chunked, kernels, ransac, tridiag


def n_trial_keys(cfg):
    """Trials whose keys JAX splits: ``max_trials``, or the whole adaptive
    schedule's n_chunks * chunk."""
    if cfg.stop_probability is None:
        return cfg.max_trials
    chunk = min(cfg.adaptive_chunk, cfg.max_trials)
    return -(-cfg.max_trials // chunk) * chunk


@pytest.fixture
def jax_loop_counts(monkeypatch):
    """Every ``jax.lax.while_loop`` run while the fixture is active appends
    the number of iterations it made (one entry a lane under ``vmap``)."""
    counts = []
    real = jax.lax.while_loop

    def counting(cond, body, init):
        state, n = real(lambda s: cond(s[0]), lambda s: (body(s[0]), s[1] + 1),
                        (init, jnp.zeros((), jnp.int32)))
        jax.debug.callback(lambda n: counts.extend(np.atleast_1d(np.asarray(n)).tolist()), n)
        return state

    monkeypatch.setattr(jax.lax, "while_loop", counting)
    yield counts


def jax_sim3_draws(key, valid, cfg):
    keys = jax.random.split(key, n_trial_keys(cfg))
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


@pytest.mark.parametrize("seed,outliers,p,chunks", [(0, 0.25, 0.99, 1), (1, 0.45, 0.9999, 2), (2, 0.6, 0.999999, 7),
                                                    (3, 0.0, 0.9999, 1)])
def test_sim3_ransac_adaptive_stops_where_jax_stops(seed, outliers, p, chunks, jax_loop_counts, monkeypatch):
    """``stop_probability`` with JAX's draws replayed: the same number of
    chunks run (K5's wrapper is called once a chunk), the same winner and
    inlier mask. 200 trials in chunks of 32 are 7 chunks and 224 keys."""
    src, dst, valid = sim3_problem(seed, outliers=outliers)
    kw = dict(max_trials=200, stop_probability=p, adaptive_chunk=32)
    jcfg, cfg = JSim3RansacConfig(**kw), Sim3RansacConfig(**kw)
    key = jax.random.PRNGKey(seed)
    want = jr.sim3_ransac(key, jnp.asarray(src), jnp.asarray(dst), valid=jnp.asarray(valid), cfg=jcfg,
                          platform="cpu")
    jax.effects_barrier()
    draws = jax_sim3_draws(key, valid, jcfg)
    assert draws.shape == (224, 4)
    calls = []
    monkeypatch.setattr(ransac, "ransac_counts", lambda *a: calls.append(1) or kernels.ransac_counts(*a))
    got = ransac.sim3_ransac(torch.tensor(src), torch.tensor(dst), torch.tensor(valid), cfg=cfg,
                             draws=torch.tensor(draws))
    assert len(calls) == jax_loop_counts[-1] == chunks
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert int(got.num_inliers) == int(want.num_inliers) and bool(got.ok) == bool(want.ok) is True
    np.testing.assert_allclose(got.sim3.R.numpy(), np.asarray(want.sim3.R), atol=1e-10)
    np.testing.assert_allclose(got.sim3.t.numpy(), np.asarray(want.sim3.t), rtol=1e-10)
    assert abs(float(got.sim3.scale) - float(want.sim3.scale)) <= 1e-10


def test_sim3_ransac_adaptive_recovers_the_fixed_run_inliers():
    """Own draws from a seed: early stopping finds the inlier set of the
    fixed 1000-trial run on contaminated data
    (tests/test_umeyama_ransac.py:309-340 of the JAX package)."""
    rng = np.random.default_rng(11)
    n = 300
    src = rng.normal(size=(n, 3)) * 20
    dst = 0.97 * src + np.array([5.0, -2.0, 1.0]) + rng.normal(size=(n, 3)) * 0.05
    bad = rng.choice(n, 45, replace=False)
    dst[bad] += rng.normal(size=(45, 3)) * 200.0
    fixed = ransac.sim3_ransac(torch.tensor(src), torch.tensor(dst), cfg=Sim3RansacConfig())
    adaptive = ransac.sim3_ransac(torch.tensor(src), torch.tensor(dst),
                                  cfg=Sim3RansacConfig(stop_probability=0.9999))
    assert bool(fixed.ok) and bool(adaptive.ok)
    assert torch.equal(adaptive.inlier_mask, fixed.inlier_mask)
    assert not adaptive.inlier_mask.numpy()[bad].any() and int(adaptive.num_inliers) >= n - 50
    np.testing.assert_allclose(adaptive.sim3.R.numpy(), fixed.sim3.R.numpy(), atol=1e-12)
    # The streaming form hands its config to the same trials: the same stop.
    streamed = alignment_chunked.sim3_ransac_streaming(
        src, dst, np.ones(n, bool), cfg=Sim3RansacConfig(stop_probability=0.9999), device="cpu")
    assert streamed.num_inliers == int(adaptive.num_inliers) and not streamed.subsampled
    np.testing.assert_allclose(streamed.sim3.R.numpy(), adaptive.sim3.R.numpy(), atol=1e-12)


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
            keys = jax.random.split(k, n_trial_keys(cfg))
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


@pytest.mark.parametrize("sliding,p", [(True, 0.99), (False, 0.999999)])
def test_gps_gate_adaptive_stops_where_jax_stops(sliding, p, jax_loop_counts, monkeypatch):
    """The gate under ``stop_probability`` with JAX's draws replayed: the
    same mask (every window and axis freezes at its own chunk), and the
    port's loop runs as many chunks as JAX's slowest lane. 50 trials in
    chunks of 8 are 7 chunks and 56 keys."""
    t, pos, valid = gnss_track(12)
    kw = dict(use_sliding_window=sliding, stop_probability=p, adaptive_chunk=8)
    cfg, jcfg = GPSFilterConfig(**kw), JGPSFilterConfig(**kw)
    starts = jr.reference_window_starts(t[valid], jcfg) if sliding else None
    key = jax.random.PRNGKey(5)
    gate = jax.jit(functools.partial(jr.gps_poly_ransac_mask, cfg=jcfg))
    want = np.asarray(gate(key, jnp.asarray(t), jnp.asarray(pos), valid=jnp.asarray(valid),
                           window_starts=None if starts is None else jnp.asarray(starts)))
    jax.effects_barrier()
    lanes = (len(starts) if sliding else 1) * 3
    assert len(jax_loop_counts) == lanes and 1 <= max(jax_loop_counts) < 7
    draws = jax_gate_draws(key, jnp.asarray(t), jnp.asarray(valid), starts, jcfg)
    assert draws.shape[2:] == (56, 6)
    fits = []
    real_pinv = torch.linalg.pinv
    monkeypatch.setattr(torch.linalg, "pinv", lambda x: fits.append(1) or real_pinv(x))
    got = ransac.gps_poly_ransac_mask(
        torch.tensor(t), torch.tensor(pos), valid=torch.tensor(valid),
        window_starts=None if starts is None else torch.tensor(starts),
        cfg=cfg, draws=torch.tensor(draws),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(fits) == max(jax_loop_counts)
    assert 0 < (valid & ~got).sum() <= 20


@pytest.mark.parametrize("adaptive", [False, True])
def test_gps_gate_in_window_blocks_matches_jax(adaptive, monkeypatch):
    """A log whose gate outgrows ``GATE_BLOCK_ELEMENTS`` takes its sliding
    windows in blocks (here one or two windows a block): with JAX's draws
    replayed the mask is JAX's, under ``stop_probability`` too (each window
    stops on its own bound, whatever block it is in)."""
    t, pos, valid = gnss_track(13, n=600)
    kw = dict(stop_probability=0.99, adaptive_chunk=8) if adaptive else {}
    cfg, jcfg = GPSFilterConfig(**kw), JGPSFilterConfig(**kw)
    starts = jr.reference_window_starts(t[valid], jcfg)
    key = jax.random.PRNGKey(7)
    gate = jax.jit(functools.partial(jr.gps_poly_ransac_mask, cfg=jcfg))
    want = np.asarray(gate(key, jnp.asarray(t), jnp.asarray(pos), valid=jnp.asarray(valid),
                           window_starts=jnp.asarray(starts)))
    draws = torch.tensor(jax_gate_draws(key, jnp.asarray(t), jnp.asarray(valid), starts, jcfg))
    args = (torch.tensor(t), torch.tensor(pos))
    kwargs = dict(valid=torch.tensor(valid), window_starts=torch.tensor(starts), cfg=cfg)
    one_block = ransac.gps_poly_ransac_mask(*args, draws=draws, **kwargs)
    seeded = ransac.gps_poly_ransac_mask(*args, seed=4, **kwargs)
    calls = []
    real = ransac._gate_windows
    monkeypatch.setattr(ransac, "_gate_windows", lambda *a: calls.append(a[2].shape[0]) or real(*a))
    monkeypatch.setattr(ransac, "GATE_BLOCK_ELEMENTS", 2 * 3 * draws.shape[2] * len(t) - 1)
    got = ransac.gps_poly_ransac_mask(*args, draws=draws, **kwargs)
    assert len(starts) > 4 and calls == [1] * len(starts)  # a window a block
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(one_block.numpy(), want)
    blocked = ransac.gps_poly_ransac_mask(*args, seed=4, **kwargs)
    assert 0 < (valid & ~blocked.numpy()).sum() <= 30 and 0 < (valid & ~seeded.numpy()).sum() <= 30


@pytest.mark.parametrize("step_factor,duration,n_valid", [(0.5, 15.0, None), (0.5, 15.0, 140), (0.3, 7.0, None),
                                                            (0.0, 15.0, None), (0.5, 500.0, None)])
def test_window_starts_device_equals_the_host_form(step_factor, duration, n_valid):
    """Half-overlapping windows, a padded row (``valid``), a short window, a
    degenerate step (a window a distinct timestamp) and one window longer
    than the track, each with room to spare and truncated."""
    t, _, _ = gnss_track(13, n=200)
    t[50] = t[49]  # a repeated timestamp
    cfg = GPSFilterConfig(window_duration_seconds=duration, window_step_factor=step_factor)
    real = t if n_valid is None else t[:n_valid]
    want = ransac.reference_window_starts(real, cfg)
    jcfg = JGPSFilterConfig(window_duration_seconds=duration, window_step_factor=step_factor)
    np.testing.assert_array_equal(want, jr.reference_window_starts(real, jcfg))
    valid = None if n_valid is None else torch.arange(len(t)) < n_valid
    for room in (len(want) + 3, max(len(want) - 2, 0)):
        starts, count = ransac.window_starts_device(torch.tensor(t), cfg, room, valid=valid)
        jstarts, jcount = jr.window_starts_device(jnp.asarray(t), jcfg, room,
                                                  valid=None if valid is None else jnp.asarray(valid.numpy()))
        assert starts.shape == (room,) and int(count) == min(len(want), room) == int(jcount)
        np.testing.assert_array_equal(starts.numpy()[: int(count)], want[: int(count)])
        assert np.isnan(starts.numpy()[int(count):]).all()
        np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    empty, none = ransac.window_starts_device(torch.zeros(0, dtype=torch.float64), cfg, 4)
    assert np.isnan(empty.numpy()).all() and empty.shape == (4,) and int(none) == 0


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
