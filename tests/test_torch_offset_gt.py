"""The clock-offset estimators, the ground-truth evaluation and the file
flows that reach them, port against the JAX package, CPU float64.

Tolerances: ``interp`` against ``np.interp`` ≤1e-12 (another rounding of the
same line); the host estimator equal to JAX's; the device estimator ≤1e-9 s
from JAX's and within one grid cell of the injected shift and of the host
estimator (tests/test_smoother_offset.py:66-131); ``evaluate_vs_track``
against JAX's every statistic ≤1e-9 relative, the aligned track ≤1e-9 m;
chunked against in-core ≤1e-9; the file flows against the in-core port
≤1e-8 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gps_optimize_slam_tpu.config import FusionConfig as JFusionConfig
from gps_optimize_slam_tpu.models import fusion as jfusion
from gps_optimize_slam_tpu.ops import alignment as jal
from gps_optimize_slam_tpu_torch import pipeline
from gps_optimize_slam_tpu_torch.config import FusionConfig, config_from_dict
from gps_optimize_slam_tpu_torch.models import fusion, fusion_chunked
from gps_optimize_slam_tpu_torch.ops import alignment
from gps_optimize_slam_tpu_torch.ops.umeyama import Sim3
from tests.test_fusion_chunked import _scenario
from tests.test_kalman import make_traj
from tests.test_torch_ransac_alignment import jax_sim3_draws

PARTS = ("nn_slam", "nn_sim3", "nn_ekf", "ate_sim3", "ate_ekf")
STATS = ("mean", "median", "rmse", "max")


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


def assert_evaluations_close(got, want, tol):
    for part in PARTS:
        g, w = getattr(got, part), getattr(want, part)
        assert int(g.count) == int(w.count) > 0, part
        for stat in STATS:
            assert rel(getattr(g, stat), getattr(w, stat)) <= tol, (part, stat)


def test_interp_matches_numpy():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(0.0, 10.0, 40))
    xp[7] = xp[6]  # a repeated knot
    fp = rng.normal(size=40)
    x = np.concatenate([rng.uniform(-2.0, 12.0, 300), xp, [xp[0], xp[-1]]])
    got = alignment.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_allclose(got, np.interp(x, xp, fp), atol=1e-12, rtol=0)


def test_interp_takes_an_inf_padded_tail_and_resampling_zeroes_outside():
    """The device estimator's use: 25 real knots, the tail of ``xp`` padded
    with +inf and ``fp`` repeating its last real value; inside the real span
    it equals ``np.interp`` on the real knots, and with the estimator's
    zeroing outside [first, last] it equals ``np.interp(left=0, right=0)``."""
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0.0, 10.0, 25))
    fp = rng.uniform(0.5, 3.0, 25)
    xp_pad = np.concatenate([xp, np.full(15, np.inf)])
    fp_pad = np.concatenate([fp, np.full(15, fp[-1])])
    x = np.linspace(-3.0, 14.0, 500)
    y = alignment.interp(torch.tensor(x), torch.tensor(xp_pad), torch.tensor(fp_pad))
    assert torch.isfinite(y).all()
    y = torch.where(torch.tensor((x < xp[0]) | (x > xp[-1])), 0.0, y).numpy()
    np.testing.assert_allclose(y, np.interp(x, xp, fp, left=0.0, right=0.0), atol=1e-12, rtol=0)
    assert (y[x > xp[-1]] == 0).all() and (y[x < xp[0]] == 0).all() and (y != 0).sum() > 200


def shifted_track(shift, seed=8, n=400, m=380):
    t, pos, _ = make_traj(n=n, seed=7)
    rng = np.random.default_rng(seed)
    gt = np.linspace(t[0], t[-1], m)
    gp = np.stack([np.interp(gt, t, pos[:, k]) for k in range(3)], -1) * 0.97 + rng.normal(size=(m, 3)) * 0.02
    return t, pos, gt + shift, gp


@pytest.mark.parametrize("shift", [-2.3, 0.0, 1.7, 4.9])
def test_xcorr_offsets_match_jax_and_recover_the_shift(shift):
    t, pos, gt, gp = shifted_track(shift)
    host = alignment.estimate_time_offset_xcorr(t, pos, gt, gp, max_lag_seconds=8.0)
    assert host == jal.estimate_time_offset_xcorr(t, pos, gt, gp, max_lag_seconds=8.0)
    assert abs(host + shift) < 0.11
    dev = float(alignment.estimate_time_offset_xcorr_device(*(torch.tensor(a) for a in (t, pos, gt, gp)),
                                                            max_lag_seconds=8.0))
    want = float(jal.estimate_time_offset_xcorr_device(*(jnp.asarray(a) for a in (t, pos, gt, gp)),
                                                       max_lag_seconds=8.0))
    assert abs(dev - want) <= 1e-9
    assert abs(dev + shift) < 0.11 and abs(dev - host) < 0.1


def test_xcorr_device_masks_and_degenerate_inputs_match_jax():
    t, pos, gt, gp = shifted_track(1.5, n=200, m=180)
    t_pad = np.concatenate([t, t[-1] + 1 + np.arange(50.0)])
    pos_pad = np.concatenate([pos, np.tile(pos[-1], (50, 1)) + 1e3])
    mask = np.concatenate([np.ones(len(t), bool), np.zeros(50, bool)])
    gv = np.random.default_rng(2).uniform(size=len(gt)) > 0.1
    clean = float(alignment.estimate_time_offset_xcorr_device(*(torch.tensor(a) for a in (t, pos, gt, gp))))
    masked = float(alignment.estimate_time_offset_xcorr_device(
        *(torch.tensor(a) for a in (t_pad, pos_pad, gt, gp)), slam_mask=torch.tensor(mask),
        gps_valid=torch.tensor(gv)))
    want = float(jal.estimate_time_offset_xcorr_device(
        *(jnp.asarray(a) for a in (t_pad, pos_pad, gt, gp)), slam_mask=jnp.asarray(mask),
        gps_valid=jnp.asarray(gv)))
    assert abs(clean + 1.5) < 0.15 and abs(masked + 1.5) < 0.15 and abs(masked - want) <= 1e-9
    zero = alignment.estimate_time_offset_xcorr_device(
        torch.zeros(2, dtype=torch.float64), torch.zeros((2, 3), dtype=torch.float64),
        torch.tensor(gt), torch.tensor(gp))
    assert float(zero) == 0.0
    assert alignment.estimate_time_offset_xcorr(np.arange(2.0), np.zeros((2, 3)), np.arange(10.0),
                                                np.zeros((10, 3))) == 0.0


@pytest.mark.parametrize("mode", ["xcorr", "xcorr_device"])
def test_fuse_arrays_recovers_a_shifted_gnss_clock(mode):
    """GNSS timestamps 1.7 s late: the faithful estimator leaves them there,
    the cross-correlation modes bring the fusion back to the unshifted one."""
    t, pos, quats = make_traj(n=400, seed=7)
    _, _, gt, gp = shifted_track(1.7)
    slam = {"timestamps": t, "positions": pos, "quaternions": quats}
    gps = pipeline.GPSData(timestamps=gt, positions=gp / 0.97, valid=np.ones(len(gt), bool), frame="enu",
                           utm_zone=32, utm_south=False)
    res = pipeline.fuse_arrays(slam, gps, config=FusionConfig(offset_mode=mode), device="cpu")
    off = pipeline.fuse_arrays(slam, gps, config=FusionConfig(offset_mode="faithful"), device="cpu")
    assert abs(res.time_offset + 1.7) < 0.11 and off.time_offset == 0.0
    # Against the true positions: 1.7 s late at 2 m/s is 3.4 m along the track.
    err, err_off = (np.median(np.linalg.norm(r.corrected_pos - pos, axis=1)) for r in (res, off))
    assert err < 0.3 and err_off > 2.0
    with pytest.raises(ValueError, match="offset_mode"):
        pipeline.fuse_arrays(slam, gps, config=FusionConfig(offset_mode="guess"), device="cpu")


@pytest.fixture(scope="module")
def fused():
    """JAX's in-core fusion of the chunked e2e scenario, the port's with
    JAX's draws, and an independent track with its own clock."""
    (st, sp, sq), (gt, gp, gv) = _scenario(seed=5)
    jcfg = JFusionConfig()
    key = jax.random.PRNGKey(0)
    jout = jfusion.fuse_core(*(jnp.asarray(a) for a in (st, sp, sq, gt, gp, gv)), key, config=jcfg)
    aligned = jal.align_gps_to_slam(jnp.asarray(st), jnp.asarray(gt), jnp.asarray(gp), gps_valid=jnp.asarray(gv))
    window = jal.sim3_window_mask(jnp.asarray(st), aligned.valid, 5.0, 180.0, 4)
    draws = jax_sim3_draws(key, np.asarray(window), jcfg.sim3_ransac)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    out = fusion.fuse_core(*(torch.tensor(a) for a in (st, sp, sq, gt, gp, gv)), cfg,
                           sim3_draws=torch.tensor(draws))
    rng = np.random.default_rng(99)
    m = 500
    tt = np.sort(rng.uniform(st[0], st[-1], m))
    tp = np.stack([np.interp(tt, st, np.asarray(jout.sim3_pos)[:, k]) for k in range(3)], -1)
    tp += rng.normal(size=(m, 3)) * 0.02
    tv = np.ones(m, bool)
    tv[rng.choice(m, 15, replace=False)] = False
    return (st, sp, sq), (tt, tp, tv), jcfg, jout, cfg, out


def test_evaluate_vs_track_matches_jax(fused):
    (st, sp, _), track, jcfg, jout, cfg, out = fused
    want, want_al = jfusion.evaluate_vs_track(jnp.asarray(st), jnp.asarray(sp), jout,
                                              *(jnp.asarray(a) for a in track), cfg=jcfg)
    got, got_al = fusion.evaluate_vs_track(torch.tensor(st), torch.tensor(sp), out,
                                           *(torch.tensor(a) for a in track), cfg=cfg)
    np.testing.assert_array_equal(got_al.valid.numpy(), np.asarray(want_al.valid))
    v = got_al.valid.numpy()
    np.testing.assert_allclose(got_al.aligned.numpy()[v], np.asarray(want_al.aligned)[v], atol=1e-9, rtol=0)
    assert_evaluations_close(got, want, 1e-9)
    # Another track than the GNSS the fusion used: other statistics.
    assert rel(got.nn_ekf.rmse, fusion.evaluate(torch.tensor(st), torch.tensor(sp), out).nn_ekf.rmse) > 1e-3


@pytest.mark.parametrize("chunk_size", [131, 4096])
def test_evaluate_vs_track_chunked_matches_in_core(fused, chunk_size):
    """Chunks of 131 split the trajectory, the candidates and the track's
    own chunk + halo alignment; 4096 is one padded chunk."""
    (st, sp, sq), (tt, tp, tv), _, _, cfg, out = fused
    want, want_al = fusion.evaluate_vs_track(torch.tensor(st), torch.tensor(sp), out,
                                             torch.tensor(tt), torch.tensor(tp), torch.tensor(tv), cfg=cfg)
    res = fusion_chunked.ChunkedFusionResult(
        corrected_pos=out.corrected_pos.numpy(), corrected_quat=out.corrected_quat.numpy(),
        sim3=Sim3(*out.sim3), aligned_gps=out.aligned_gps.numpy(), gps_valid=out.gps_valid.numpy(),
        num_inliers=int(out.sim3_inliers.sum()), ok=True,
    )
    got, got_al = fusion_chunked.evaluate_vs_track_chunked(st, sp, sq, res, tt, tp, track_valid=tv, cfg=cfg,
                                                          chunk_size=chunk_size, device="cpu")
    np.testing.assert_array_equal(got_al.valid, want_al.valid.numpy())
    np.testing.assert_allclose(got_al.aligned[got_al.valid], want_al.aligned.numpy()[got_al.valid],
                               atol=1e-9, rtol=0)
    assert_evaluations_close(got, want, 1e-9)
    plain = fusion_chunked.evaluate_chunked(st, sp, sq, res, chunk_size=chunk_size, device="cpu")
    assert_evaluations_close(plain, fusion.evaluate(torch.tensor(st), torch.tensor(sp), out), 1e-9)


@pytest.fixture(scope="module")
def seq04_files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("seq04"))
    slam_path, gps_path = chip_smoke.write_seq04_files(tmp)
    return slam_path, gps_path, chip_smoke.write_seq04_gt_file(tmp)


def test_fuse_files_with_ground_truth_and_robust_gate(seq04_files):
    slam_path, gps_path, gt_path = seq04_files
    cfg = FusionConfig(platform="gpu")  # the parallel scans, as on the card
    res = pipeline.fuse_files(slam_path, gps_path, config=cfg, device="cpu", gt_path=gt_path, robust=True)
    plain = pipeline.fuse_files(slam_path, gps_path, config=cfg, device="cpu")
    assert plain.gt is None and plain.gt_evaluation is None and plain.robust_accepted is None
    assert res.gt.frame == "utm" and (res.gt.utm_zone, res.gt.utm_south) == (32, False)
    assert res.gt.valid.all() and res.gt.valid.shape == (250,)
    # The file is lon-first: read lat-first it would project somewhere else.
    assert np.abs(res.gt.positions[:, :2] - res.gps.positions[:, :2].mean(0)).max() < 2000.0
    assert res.robust_accepted.dtype == bool and res.robust_accepted.shape == (271,)
    valid = res.outputs.gps_valid.numpy()
    assert not (res.robust_accepted & ~valid).any() and res.robust_accepted.sum() >= valid.sum() - 5
    np.testing.assert_allclose(res.corrected_pos, plain.corrected_pos, atol=0.05, rtol=0)
    gv = res.gt_evaluation
    assert int(gv.nn_ekf.count) > 200 and 0.02 < float(gv.nn_ekf.rmse) < 0.3
    assert float(gv.nn_ekf.rmse) < float(gv.nn_sim3.rmse)
    assert res.gt_aligned.aligned.shape == (271, 3) and int(res.gt_aligned.valid.sum()) >= int(gv.nn_ekf.count)
    text = res.summary()
    assert "vs GT: Sim3 (NN)" in text and "vs GT: EKF  (NN)" in text and "vs GT" not in plain.summary()


def test_fuse_files_chunked_with_ground_truth_and_robust_gate(seq04_files):
    """The chunked file flow against the in-core one: the robust gate of
    ``fuse_files_chunked`` is the parallel gate, so the in-core side is
    ``fuse_arrays(robust_gate_mode="parallel")`` on the same tracks."""
    slam_path, gps_path, gt_path = seq04_files
    cfg = FusionConfig(platform="gpu")
    res = pipeline.fuse_files_chunked(slam_path, gps_path, config=cfg, chunk_size=100, device="cpu",
                                      gt_path=gt_path, robust=True, robust_iterations=4)
    loaded = pipeline.fuse_files(slam_path, gps_path, config=cfg, device="cpu", gt_path=gt_path)
    ref = pipeline.fuse_arrays(loaded.slam, loaded.gps, config=cfg, device="cpu", gt=loaded.gt, robust=True,
                               robust_iterations=4, robust_gate_mode="parallel")
    np.testing.assert_array_equal(res.result.robust_accepted, ref.robust_accepted)
    np.testing.assert_allclose(res.corrected_pos, ref.corrected_pos, atol=1e-8, rtol=0)
    np.testing.assert_array_equal(res.gt_aligned.valid, ref.gt_aligned.valid.numpy())
    assert_evaluations_close(res.gt_evaluation, ref.gt_evaluation, 1e-6)
    assert_evaluations_close(res.evaluation, ref.evaluation, 1e-6)
    text = res.summary()
    assert "robust χ² gate: accepted=" in text and "vs ground-truth GNSS:" in text
    plain = pipeline.fuse_files_chunked(slam_path, gps_path, config=cfg, chunk_size=100, device="cpu")
    assert plain.gt_evaluation is None and plain.result.robust_accepted is None
    assert "robust" not in plain.summary() and "ground-truth" not in plain.summary()


def test_ground_truth_in_another_frame_is_refused(seq04_files):
    slam_path, gps_path, gt_path = seq04_files
    res = pipeline.fuse_files(slam_path, gps_path, device="cpu")
    gt = pipeline.load_and_project_gps(gt_path, res.config.ground_truth_gps_filtering, frame="enu",
                                       lon_first=True, device="cpu")
    with pytest.raises(ValueError, match="ground-truth frame"):
        pipeline.fuse_arrays(res.slam, res.gps, device="cpu", gt=gt)
    like = pipeline.load_and_project_gps(gt_path, res.config.ground_truth_gps_filtering, frame="enu",
                                         lon_first=True, device="cpu", like=res.gps)
    assert like.frame == "utm" and like.enu_origin is None
    enu = pipeline.load_and_project_gps(gps_path, res.config.gps_filtering_ransac, frame="enu", device="cpu")
    gt_enu = pipeline.load_and_project_gps(gt_path, res.config.ground_truth_gps_filtering, lon_first=True,
                                           device="cpu", like=enu)
    np.testing.assert_array_equal(gt_enu.enu_origin, enu.enu_origin)
    assert gt_enu.frame == "enu" and np.abs(gt_enu.positions).max() < 2000.0
